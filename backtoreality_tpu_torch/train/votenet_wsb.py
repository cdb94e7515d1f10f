"""CLI entry point: VoteNet WSB (mirrors train_Votenet_WSB.py).

    python -m backtoreality_tpu_torch.train.votenet_wsb --data_root D \
        [--device cpu] [...]

Flags: see ``train/votenet.py``.
"""

from backtoreality_tpu_torch.train import votenet


def main(argv=None):
    """Train the wsb recipe; returns the model and its optimizer."""
    return votenet.main("wsb", argv)


if __name__ == "__main__":
    main()
