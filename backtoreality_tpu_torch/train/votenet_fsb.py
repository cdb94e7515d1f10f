"""CLI entry point: VoteNet FSB (mirrors train_Votenet_FSB.py).

    python -m backtoreality_tpu_torch.train.votenet_fsb --data_root D \
        [--device cpu] [...]

Flags: see ``train/votenet.py``.
"""

from backtoreality_tpu_torch.train import votenet


def main(argv=None):
    """Train the FSB recipe; returns the model and its optimizer."""
    return votenet.main("fsb", argv)


if __name__ == "__main__":
    main()
