"""CLI entry point: GroupFree3D WSB (mirrors train_GF_WSB.py).

    python -m backtoreality_tpu_torch.train.gf_wsb --data_root D \
        [--device cpu] [...]

Flags: see ``train/groupfree.py``.
"""

from backtoreality_tpu_torch.train import groupfree


def main(argv=None):
    """Train the WSB recipe; returns the model and its optimizer."""
    return groupfree.main("wsb", argv)


if __name__ == "__main__":
    main()
