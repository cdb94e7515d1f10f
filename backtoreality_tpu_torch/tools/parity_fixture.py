"""Write the synthetic fixtures of the parity and quality studies.

Counterpart of ``backtoreality_tpu/tools/parity_fixture.py``: the same
files, bit for bit (seeded):

  --kind parity    System-level training parity (the reference's loop
                   against the port's): 40 train / 12 val scans, seeds
                   41/42.
  --kind br        BR/CenterRefine two-domain study: target ("real")
                   train+val seeds 21/22 and a distribution-shifted
                   source ("virtual", scene_aug names) seed 23. Use
                   with the trainers' `--center_jitter` to inject the
                   annotation error under study.
  --kind qfix      The quality fixture: 40/12 scans, seeds 11/12.
  --kind shapefix  bf16-precision study fixture: classes differ by
                   SHAPE (rich procedural library, 22 families, rng 7),
                   seeds 31/32 (`datagen/shapefix.py`).

Usage:
  python -m backtoreality_tpu_torch.tools.parity_fixture --kind parity \
      --out OUT
"""

from __future__ import annotations

import argparse
import pathlib

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
from backtoreality_tpu_torch.datagen import shapefix

KINDS = ("parity", "br", "qfix", "shapefix")


def write_fixture(kind: str, out, train_scans: int = 40,
                  val_scans: int = 12, val_seed: int | None = None):
    """Write the `kind` fixture under `out`; returns its parts' paths."""
    if kind not in KINDS:
        raise ValueError(f"unknown fixture kind {kind!r}")
    out = pathlib.Path(out)
    cfg = get_config("scannet_md40")
    kw = dict(num_objects=6, points_per_object=1200, floor_points=6000)

    if kind in ("parity", "qfix"):
        tr, va = (41, 42) if kind == "parity" else (11, 12)
        va = val_seed if val_seed is not None else va
        write_synthetic_scans(out / "train", cfg, num_scans=train_scans,
                              seed=tr, **kw)
        write_synthetic_scans(out / "val", cfg, num_scans=val_scans,
                              seed=va, **kw)
        parts = ["train", "val"]
    elif kind == "br":
        write_synthetic_scans(out / "real", cfg, num_scans=train_scans,
                              seed=21, **kw)
        write_synthetic_scans(out / "val", cfg, num_scans=val_scans,
                              seed=val_seed if val_seed is not None else 22,
                              **kw)
        # source domain: full labels, shifted distribution (another seed
        # and object count); names carry "aug" for train_aug splits
        write_synthetic_scans(out / "virtual", cfg, num_scans=train_scans,
                              num_objects=8, points_per_object=1000,
                              floor_points=5000, seed=23, prefix="scene_aug")
        # the reference parses aug scan names as their first 18 chars
        # (`scannet_detection_dataset.py:69`, names like
        # scene_augXXXX_YY_k): pad ours to that convention, as the JAX
        # tool does
        for f in (out / "virtual").glob("scene_aug*.npy"):
            stem16, suffix = f.name[:16], f.name[16:]
            if not suffix.startswith("_1"):
                f.rename(f.with_name(stem16 + "_1" + suffix))
        parts = ["real", "val", "virtual"]
    else:
        shapefix.write_shapefix_val(out / "train", train_scans,
                                    shapefix.TRAIN_SEED)
        shapefix.write_shapefix_val(
            out / "val", val_scans,
            val_seed if val_seed is not None else shapefix.VAL_SEED)
        parts = ["train", "val"]
    return [out / p for p in parts]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kind", default="parity", choices=KINDS)
    parser.add_argument("--out", required=True, help="output root")
    parser.add_argument("--train_scans", type=int, default=40)
    parser.add_argument("--val_scans", type=int, default=12)
    parser.add_argument("--val_seed", type=int, default=None,
                        help="override the kind's val seed (e.g. a"
                             " fresh 100-scan val split)")
    args = parser.parse_args(argv)
    parts = write_fixture(args.kind, args.out, args.train_scans,
                          args.val_scans, args.val_seed)
    print(f"{args.kind} fixture ready: " + ", ".join(map(str, parts)))
    return parts


if __name__ == "__main__":
    main()
