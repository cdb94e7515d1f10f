"""CLI entry point: GroupFree3D BR+CenterRefine (mirrors
train_GF_BR_CenterRefine.py).

    python -m backtoreality_tpu_torch.train.gf_br_center_refine \
        --data_root REAL --source_data_root VIRTUAL \
        [--checkpoint_path BR_LOG/ckpt_epoch_last.tar] [--device cpu] [...]

``--checkpoint_path`` without ``--resume`` grafts BR's weights; the
jitter head's layers start fresh. Flags: see ``train/groupfree.py``.
"""

from backtoreality_tpu_torch.train import groupfree


def main(argv=None):
    """Train the BR+CenterRefine recipe; returns the model and its
    optimizer."""
    return groupfree.main("br_center_refine", argv)


if __name__ == "__main__":
    main()
