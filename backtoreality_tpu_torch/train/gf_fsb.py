"""CLI entry point: GroupFree3D FSB (mirrors train_GF_FSB.py).

    python -m backtoreality_tpu_torch.train.gf_fsb --data_root D \
        [--device cpu] [...]

Flags: see ``train/groupfree.py``.
"""

from backtoreality_tpu_torch.train import groupfree


def main(argv=None):
    """Train the FSB recipe; returns the model and its optimizer."""
    return groupfree.main("fsb", argv)


if __name__ == "__main__":
    main()
