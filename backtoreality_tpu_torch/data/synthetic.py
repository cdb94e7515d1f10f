"""Synthetic scan generator.

Produces scans in the exact npy-quadruple format the datasets consume
(`{scan}_vert.npy`, `_ins_label.npy`, `_sem_label.npy`, `_bbox.npy`),
used for unit tests, the end-to-end smoke train, and benchmarking when
the real ScanNet/Matterport exports are not present. Scenes are simple
rooms: a floor plane plus axis-aligned (or rotated, for matterport-style
configs) box objects with surface-sampled points, sized by the config's
per-class mean sizes so the label codecs are exercised realistically.
"""

from __future__ import annotations

import pathlib

import numpy as np

from backtoreality_tpu_torch.data.config import DatasetConfig


def _sample_box_surface(rng, center, dims, angle, npts):
    """Uniform points on the surface of an oriented box."""
    areas = np.array([
        dims[0] * dims[1],  # top/bottom
        dims[0] * dims[2],  # front/back
        dims[1] * dims[2],  # left/right
    ])
    areas = np.repeat(areas, 2)
    probs = areas / areas.sum()
    face = rng.choice(6, size=npts, p=probs)
    u = rng.random(npts) - 0.5
    v = rng.random(npts) - 0.5
    pts = np.zeros((npts, 3))
    half = np.asarray(dims) / 2
    for f in range(6):
        m = face == f
        axis = f // 2
        sign = 1.0 if f % 2 == 0 else -1.0
        other = [a for a in range(3) if a != axis]
        pts[m, axis] = sign * half[axis]
        pts[m, other[0]] = u[m] * dims[other[0]]
        pts[m, other[1]] = v[m] * dims[other[1]]
    if angle != 0.0:
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pts = pts @ rot.T
    return pts + np.asarray(center)


def generate_scene(
    config: DatasetConfig,
    rng: np.random.Generator,
    num_objects: int = 8,
    room_size: float = 6.0,
    points_per_object: int = 2000,
    floor_points: int = 4000,
    shape_library=None,
):
    """Returns (verts (N,6), ins_label (N,), sem_label (N,), bbox (K,7|8)).

    With `shape_library` (a `datagen.library.ShapeLibrary`, e.g.
    `procedural_library`), objects are sampled from per-class shape
    geometry instead of plain box surfaces — classes then differ by
    SHAPE, not just box dims (needed e.g. to test precision recipes on
    geometry-differentiated classes)."""
    rotated = config.num_heading_bin > 1
    verts, ins, sem = [], [], []
    bboxes = []

    lib_shapes = None
    if shape_library is not None:
        # deterministic per-class shape lists in config class order
        lib_names = sorted(shape_library.shapes)
        lib_shapes = [
            shape_library.shapes[lib_names[c % len(lib_names)]]
            for c in range(config.num_class)
        ]

    floor = np.zeros((floor_points, 3))
    floor[:, 0] = (rng.random(floor_points) - 0.5) * room_size
    floor[:, 1] = (rng.random(floor_points) - 0.5) * room_size
    floor[:, 2] = rng.random(floor_points) * 0.02
    verts.append(floor)
    ins.append(np.zeros(floor_points, dtype=np.int64))
    sem.append(np.zeros(floor_points, dtype=np.int64))  # 0 = unlabeled

    for i in range(num_objects):
        cls = int(rng.integers(0, config.num_class))
        raw_id = int(config.raw_ids[cls])
        dims = config.mean_size_arr[cls] * (0.8 + 0.4 * rng.random(3))
        angle = float(rng.random() * 2 * np.pi) if rotated else 0.0
        center = np.array([
            (rng.random() - 0.5) * (room_size - 2),
            (rng.random() - 0.5) * (room_size - 2),
            dims[2] / 2,
        ])
        if lib_shapes is not None:
            rec = lib_shapes[cls][int(rng.integers(len(lib_shapes[cls])))]
            src = rec.points - (rec.points.max(0) + rec.points.min(0)) / 2
            ext = np.maximum(src.max(0) - src.min(0), 1e-9)
            src = src * (np.asarray(dims) / ext)  # scale to class dims
            sel = rng.choice(len(src), size=points_per_object,
                             replace=len(src) < points_per_object)
            pts = src[sel]
            if angle != 0.0:
                c_, s_ = np.cos(angle), np.sin(angle)
                rot = np.array([[c_, -s_, 0], [s_, c_, 0], [0, 0, 1]])
                pts = pts @ rot.T
            pts = pts + center
        else:
            pts = _sample_box_surface(rng, center, dims, angle,
                                      points_per_object)
        verts.append(pts)
        ins.append(np.full(points_per_object, i + 1, dtype=np.int64))
        sem.append(np.full(points_per_object, raw_id, dtype=np.int64))
        if rotated:
            bboxes.append([*center, *dims, angle, raw_id])
        else:
            bboxes.append([*center, *dims, raw_id])

    xyz = np.concatenate(verts)
    rgb = rng.random((xyz.shape[0], 3)) * 255.0
    return (
        np.concatenate([xyz, rgb], axis=1).astype(np.float32),
        np.concatenate(ins),
        np.concatenate(sem),
        np.asarray(bboxes, dtype=np.float64),
    )


def write_synthetic_scans(
    out_dir,
    config: DatasetConfig,
    num_scans: int = 4,
    seed: int = 0,
    prefix: str = "scene",
    **scene_kwargs,
) -> list[str]:
    """Write `num_scans` synthetic scans into out_dir; returns scan names."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(num_scans):
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        verts, ins, sem, bbox = generate_scene(config, rng,
                                               **scene_kwargs)
        name = f"{prefix}{i:04d}_00"
        np.save(out / f"{name}_vert.npy", verts)
        np.save(out / f"{name}_ins_label.npy", ins)
        np.save(out / f"{name}_sem_label.npy", sem)
        np.save(out / f"{name}_bbox.npy", bbox)
        names.append(name)
    return names
