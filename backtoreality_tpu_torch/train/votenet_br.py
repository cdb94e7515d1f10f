"""CLI entry point: VoteNet BR (mirrors train_Votenet_BR.py).

    python -m backtoreality_tpu_torch.train.votenet_br --data_root D \
        --source_data_root V [--device cpu] [...]

Flags: see ``train/votenet.py``.
"""

from backtoreality_tpu_torch.train import votenet


def main(argv=None):
    """Train the br recipe; returns the model and its optimizer."""
    return votenet.main("br", argv)


if __name__ == "__main__":
    main()
