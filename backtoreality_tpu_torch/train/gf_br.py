"""CLI entry point: GroupFree3D BR (mirrors train_GF_BR.py).

    python -m backtoreality_tpu_torch.train.gf_br --data_root REAL \
        --source_data_root VIRTUAL [--device cpu] [...]

Flags: see ``train/groupfree.py``.
"""

from backtoreality_tpu_torch.train import groupfree


def main(argv=None):
    """Train the BR recipe; returns the model and its optimizer."""
    return groupfree.main("br", argv)


if __name__ == "__main__":
    main()
