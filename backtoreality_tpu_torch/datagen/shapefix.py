"""The shapefix fixture: its train split, its 12-scan val, and the
100-scan val that the trained checkpoint
``evidence/round4/ckpt/lad_f32.tar.gz`` is scored on.

Counterpart of ``--kind shapefix`` of the JAX package's
``tools/parity_fixture.py`` (`:92-105`): classes that differ by shape
(the rich procedural library of 22 families, its rng seeded 7), 6
objects of 1200 points and 6000 floor points a scan; the train split
seeded 31 (40 scans), the val seeded 32 (12 scans) or another seed for
a larger val. It writes the same files bit for bit.

    python -m backtoreality_tpu_torch.datagen.shapefix OUT \
        [--val_scans 100] [--val_seed 33]
    python -m backtoreality_tpu_torch.datagen.shapefix OUT --train \
        [--train_scans 40]

The first writes the val scans into OUT; the second writes OUT/train and
OUT/val (the 40 and 12 scans that GroupFree3D's shapefix run trained and
evaluated on). Then, for example, score the checkpoint on the 100 scans
(``--device cpu`` where there is no card):

    python -m backtoreality_tpu_torch.train.evaluate \
        --checkpoint_path evidence/round4/ckpt/lad_f32.tar.gz \
        --data_root OUT --split all --num_point 20000 \
        --fps_candidates 8192 --eval_seeds 3
"""

from __future__ import annotations

import argparse
import functools
import pathlib

import numpy as np

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
from backtoreality_tpu_torch.datagen.library import rich_procedural_library

SCENE = dict(num_objects=6, points_per_object=1200, floor_points=6000)
TRAIN_SEED, VAL_SEED = 31, 32


@functools.lru_cache(maxsize=1)
def _library():
    """The fixture's shape library (read-only; one for every split, as
    the JAX tool builds it once)."""
    return rich_procedural_library(num_families=22,
                                   rng=np.random.default_rng(7))


def _write(out_dir, num_scans, seed):
    return write_synthetic_scans(out_dir, get_config("scannet_md40"),
                                 num_scans=num_scans, seed=seed,
                                 shape_library=_library(), **SCENE)


def write_shapefix_val(out_dir, num_scans: int = 100, seed: int = 33):
    """Write shapefix validation scans into `out_dir`; returns their
    names."""
    return _write(out_dir, num_scans, seed)


def write_shapefix_train(out_dir, num_scans: int = 40,
                         val_scans: int = 12):
    """Write the shapefix train split into `out_dir`/train (seed 31) and
    its val into `out_dir`/val (seed 32); returns the two lists of
    names."""
    out_dir = pathlib.Path(out_dir)
    return (_write(out_dir / "train", num_scans, TRAIN_SEED),
            _write(out_dir / "val", val_scans, VAL_SEED))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out")
    parser.add_argument("--train", action="store_true",
                        help="write OUT/train and OUT/val instead")
    parser.add_argument("--train_scans", type=int, default=40)
    parser.add_argument("--val_scans", type=int, default=None,
                        help="default 100, or 12 with --train")
    parser.add_argument("--val_seed", type=int, default=33)
    args = parser.parse_args(argv)
    if args.train:
        train, val = write_shapefix_train(args.out, args.train_scans,
                                          args.val_scans or 12)
        print(f"shapefix train: {len(train)} scans, val: {len(val)} scans"
              f" in {args.out}")
        return
    names = write_shapefix_val(args.out, args.val_scans or 100,
                               args.val_seed)
    print(f"shapefix val: {len(names)} scans in {args.out}")


if __name__ == "__main__":
    main()
