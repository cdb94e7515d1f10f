"""The scenes a cell feeds its system, made from the run's seed.

One general generator, driven by a traffic file
(``portbench/traffic/<name>.json``) and the configuration's file: rooms of
``room`` metres a side with ``floor_points`` points on the floor and
``objects`` axis-aligned boxes of ``points_per_object`` surface points
each, a box's class drawn uniformly and its size the class's mean size
(the configuration's ``mean_size_arr``) times 0.8-1.2 per axis, drawn to
the configuration's ``num_point`` points (with replacement where the room
has fewer). Labels follow the detectors' ScanNet loader: box centres,
sizes, classes and residuals, per-point votes to the instance's centre,
and for GroupFree3D labels the point-to-box assignment. The height
feature is the point's height over the room's 0.99th percentile of z.

A pool of ``pool`` batches of ``batch`` scenes is made at set-up; every
scene is drawn from its own stream of (seed, pool index, row), so every
row of the pool differs and the same seed gives the same pool.
"""

from __future__ import annotations

import numpy as np


def _stream(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *key]))


def _box_surface(rng, centers, dims, npts):
    """Uniform points on the surfaces of K boxes: (K, npts, 3)."""
    k = centers.shape[0]
    areas = np.stack([dims[:, 0] * dims[:, 1], dims[:, 0] * dims[:, 2],
                      dims[:, 1] * dims[:, 2]], 1)
    probs = np.repeat(areas, 2, axis=1)
    probs = probs / probs.sum(1, keepdims=True)
    cum = np.cumsum(probs, 1)
    face = (rng.random((k, npts, 1)) > cum[:, None, :-1]).sum(-1)  # 0..5
    axis = face // 2
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    uv = rng.random((k, npts, 2)) - 0.5
    other = np.array([[1, 2], [0, 2], [0, 1]])[axis]  # (K, npts, 2)
    pts = np.zeros((k, npts, 3))
    kk = np.arange(k)[:, None]
    nn = np.arange(npts)[None, :]
    half = dims / 2
    pts[kk, nn, axis] = sign * half[kk, axis]
    pts[kk, nn, other[..., 0]] = uv[..., 0] * dims[kk, other[..., 0]]
    pts[kk, nn, other[..., 1]] = uv[..., 1] * dims[kk, other[..., 1]]
    return pts + centers[:, None, :]


def scene(rng, traffic: dict, config: dict) -> dict:
    """One labelled scene as float32/int32 numpy arrays."""
    model = config["model"]
    msa = np.asarray(config["mean_size_arr"], np.float64)
    k_max = config["max_num_obj"]
    n = model["num_point"]
    room = traffic["room"]
    nobj = traffic["objects"]
    ppo = traffic["points_per_object"]
    nfloor = traffic["floor_points"]

    floor = np.zeros((nfloor, 3))
    floor[:, 0] = (rng.random(nfloor) - 0.5) * room
    floor[:, 1] = (rng.random(nfloor) - 0.5) * room
    floor[:, 2] = rng.random(nfloor) * 0.02
    cls = rng.integers(0, model["num_class"], nobj)
    dims = msa[cls] * (0.8 + 0.4 * rng.random((nobj, 3)))
    centers = np.stack([(rng.random(nobj) - 0.5) * (room - 2),
                        (rng.random(nobj) - 0.5) * (room - 2),
                        dims[:, 2] / 2], 1)
    objs = _box_surface(rng, centers, dims, ppo).reshape(-1, 3)
    xyz = np.concatenate([floor, objs])
    instance = np.concatenate([np.full(nfloor, -1),
                               np.repeat(np.arange(nobj), ppo)])

    cloud = xyz
    if model["input_feature_dim"] == 1:  # the height feature
        height = xyz[:, 2] - np.percentile(xyz[:, 2], 0.99)
        cloud = np.concatenate([xyz, height[:, None]], 1)
    choice = rng.choice(xyz.shape[0], n, replace=xyz.shape[0] < n)
    cloud = cloud[choice]
    instance = instance[choice]
    pts = cloud[:, :3]

    gt_centers = np.zeros((k_max, 3))
    gt_centers[:nobj] = centers
    groupfree = config["labels"] == "groupfree"
    if groupfree:  # unused boxes far away, as the GroupFree3D loader
        gt_centers[nobj:] += 1000.0
    votes = np.zeros((n, 3))
    vote_mask = np.zeros(n)
    point_instance = np.full(n, -1)
    for i in range(nobj):
        ind = np.nonzero(instance == i)[0]
        if ind.size == 0:
            continue
        x = pts[ind]
        c = 0.5 * (x.min(0) + x.max(0))
        votes[ind] = c - x
        vote_mask[ind] = 1.0
        point_instance[ind] = np.argmin(((c - gt_centers) ** 2).sum(-1))
    box_mask = np.zeros(k_max)
    box_mask[:nobj] = 1
    size_class = np.zeros(k_max)
    size_class[:nobj] = cls
    size_residual = np.zeros((k_max, 3))
    size_residual[:nobj] = dims - msa[cls]
    size_gts = np.zeros((k_max, 3))
    size_gts[:nobj] = dims
    out = {
        "point_clouds": cloud.astype(np.float32),
        "center_label": gt_centers.astype(np.float32),
        "heading_class_label": np.zeros(k_max, np.int32),
        "heading_residual_label": np.zeros(k_max, np.float32),
        "size_class_label": size_class.astype(np.int32),
        "size_residual_label": size_residual.astype(np.float32),
        "size_gts": size_gts.astype(np.float32),
        "sem_cls_label": size_class.astype(np.int32),
        "box_label_mask": box_mask.astype(np.float32),
        "vote_label": np.tile(votes, (1, 3)).astype(np.float32),
        "vote_label_mask": vote_mask.astype(np.int32),
    }
    if groupfree:
        out["point_obj_mask"] = vote_mask.astype(np.int32)
        out["point_instance_label"] = point_instance.astype(np.int32)
    return out


def pool(seed: int, traffic: dict, config: dict) -> list[dict]:
    """``traffic["pool"]`` batches of ``traffic["batch"]`` scenes, each a
    dict of stacked numpy arrays."""
    batches = []
    for p in range(traffic["pool"]):
        rows = [scene(_stream(seed, 1, p, r), traffic, config)
                for r in range(traffic["batch"])]
        batches.append({k: np.stack([r[k] for r in rows]) for k in rows[0]})
    return batches
