"""The shapefix fixture's validation scans, the data the trained
checkpoint ``evidence/round4/ckpt/lad_f32.tar.gz`` is scored on.

Counterpart of ``--kind shapefix`` of the JAX package's
``tools/parity_fixture.py`` (`:91-106`): classes that differ by shape
(the rich procedural library of 22 families, its rng seeded 7), 6
objects of 1200 points and 6000 floor points a scan. It writes the same
files bit for bit.

    python -m backtoreality_tpu_torch.datagen.shapefix OUT \
        [--val_scans 100] [--val_seed 33]

then, for example, score the checkpoint on them (``--device cpu`` where
there is no card):

    python -m backtoreality_tpu_torch.train.evaluate \
        --checkpoint_path evidence/round4/ckpt/lad_f32.tar.gz \
        --data_root OUT --split all --num_point 20000 \
        --fps_candidates 8192 --eval_seeds 3
"""

from __future__ import annotations

import argparse

import numpy as np

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
from backtoreality_tpu_torch.datagen.library import rich_procedural_library

SCENE = dict(num_objects=6, points_per_object=1200, floor_points=6000)


def write_shapefix_val(out_dir, num_scans: int = 100, seed: int = 33):
    """Write the shapefix validation scans into `out_dir`; returns their
    names."""
    library = rich_procedural_library(num_families=22,
                                      rng=np.random.default_rng(7))
    return write_synthetic_scans(out_dir, get_config("scannet_md40"),
                                 num_scans=num_scans, seed=seed,
                                 shape_library=library, **SCENE)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out")
    parser.add_argument("--val_scans", type=int, default=100)
    parser.add_argument("--val_seed", type=int, default=33)
    args = parser.parse_args(argv)
    names = write_shapefix_val(args.out, args.val_scans, args.val_seed)
    print(f"shapefix val: {len(names)} scans in {args.out}")


if __name__ == "__main__":
    main()
