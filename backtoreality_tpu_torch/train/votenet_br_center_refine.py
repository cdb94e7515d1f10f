"""CLI entry point: VoteNet BR+CenterRefine (mirrors
train_Votenet_BR_CenterRefine.py).

    python -m backtoreality_tpu_torch.train.votenet_br_center_refine \
        --data_root D --source_data_root V \
        [--checkpoint_path BR_LOG/train_BR.tar] [--device cpu] [...]

A BR checkpoint given by ``--checkpoint_path`` (without ``--resume``) is
grafted in by the partial restore. Flags: see ``train/votenet.py``.
"""

from backtoreality_tpu_torch.train import votenet


def main(argv=None):
    """Train the br_center_refine recipe; returns the model and its
    optimizer."""
    return votenet.main("br_center_refine", argv)


if __name__ == "__main__":
    main()
