"""Scene synthesis: 3-stage placement + detection-scan export.

Re-design of `data_generation/ScanNet/scannet_scene_synthesis.py`
(initial placement :71-150, gravity :174-232, collision :272-385,
export :446-531) without open3d: uniform downsampling is strided,
hidden-point removal uses the Katz spherical-flip + convex-hull method
(what open3d implements), and all geometry is numpy/scipy.

The room input is abstracted as a list of :class:`SceneObject` (weak
center + class + target-dims draw) plus floor/wall points, so the same
pipeline serves the ScanNet adapter, the Matterport adapter (rotated
boxes), and data-free procedural rooms.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from backtoreality_tpu_torch.datagen.library import (
    AREA_ONLY_CLASSES,
    HEIGHT_ONLY_CLASSES,
    MDN_DICT,
    SUPPORTED_CLASSES,
    SUPPORTER_CLASSES,
    ShapeLibrary,
)
from backtoreality_tpu_torch.datagen.shapes import (
    ShapeRecord,
    mer_canonical,
    min_area_rect,
)


@dataclasses.dataclass
class SceneObject:
    """One object to place (the simulated human center-click,
    `segment_tools.py:79-167`)."""

    oid: int  # instance id (>0; 0 is floor/background)
    class_name: str
    center: np.ndarray  # (3,) weak (possibly jittered) center


@dataclasses.dataclass
class Placement:
    obj: SceneObject
    shape: ShapeRecord
    position: np.ndarray  # (3,)
    scale: np.ndarray  # (3,) per-axis
    theta: float  # degrees anticlockwise
    is_supporter: bool
    support_mer: tuple | None = None  # world-frame MER of the support top
    support_height: float | None = None


def _rot2d(theta_deg):
    """Anticlockwise rotation applied as x' = x @ R
    (`anticlock_rotate_matrix`, `scannet_scene_synthesis.py:236-239`)."""
    t = -np.radians(theta_deg)
    return np.array([[np.cos(t), np.sin(t)],
                     [-np.sin(t), np.cos(t)]])


def place_points(placement: Placement, stride: int = 1) -> np.ndarray:
    """Shape points -> world frame (`position_to_xyz`,
    `scannet_scene_synthesis.py:242-263`)."""
    pts = placement.shape.points[::stride, 0:3].copy()
    pts *= placement.scale
    pts[:, 0:2] = pts[:, 0:2] @ _rot2d(placement.theta)
    return pts + placement.position


def generate_initial_positions(objects, library: ShapeLibrary,
                               class_avg_dims, rng):
    """Stage 1 (`scannet_scene_synthesis.py:71-150`): per object draw
    target dims 0.8-1.3x the class average (random xy/yx swap), pick the
    nearest-aspect shape (supporters must be supportable), compute the
    isotropic scale (height-only / area-only exceptions), random theta.

    class_avg_dims: {class_name: (dx_xy, dy_xy, dz_xy, dx_yx, dy_yx,
    dz_yx)}."""
    placements = {}
    for obj in objects:
        name = obj.class_name
        prop = class_avg_dims[name]
        if rng.random() > 0.5:
            dxa, dya, dza = prop[3], prop[4], prop[5]
        else:
            dxa, dya, dza = prop[0], prop[1], prop[2]
        dx = (0.8 + 0.5 * rng.random()) * dxa
        dy = (0.8 + 0.5 * rng.random()) * dya
        dz = (0.8 + 0.5 * rng.random()) * dza
        ls_ratio = max(dx, dy) / max(min(dx, dy), 1e-9)
        require = name in SUPPORTER_CLASSES
        shape = library.find_nearest(name, ls_ratio,
                                     require_support=require)
        ddx, ddy, ddz = shape.extents
        scale = (dx * dx * dz / (ddx * ddy * ddz)) ** (1 / 3)
        if name in HEIGHT_ONLY_CLASSES:
            scale = dz / ddz
        if name in AREA_ONLY_CLASSES:
            scale = (dx * dy / (ddx * ddy)) ** 0.5
        theta = rng.random() * 360.0
        pl = Placement(
            obj=obj, shape=shape,
            position=np.asarray(obj.center, dtype=np.float64).copy(),
            scale=np.full(3, scale), theta=theta,
            is_supporter=require)
        if require:
            x, y, _ = pl.position
            pl.support_mer = (
                (x, y),
                (scale * max(ddx, ddy), scale * min(ddx, ddy)),
                (theta + shape.mer[2]) % 180,
            )
            pl.support_height = pl.position[2] + scale * shape.support_z
        placements[obj.oid] = pl
    return placements


def _point_in_mer(x, y, mer) -> bool:
    """(`scannet_scene_synthesis.py:153-172`)."""
    (cx, cy), (long, short), theta = mer
    d = np.array([x - cx, y - cy])
    t = np.radians(theta)
    axis_long = np.array([np.cos(t), np.sin(t)])
    axis_short = np.array([-np.sin(t), np.cos(t)])
    return (abs(d @ axis_long) < long / 2
            and abs(d @ axis_short) < short / 2)


def gravity_aware_positions(placements, floor_points):
    """Stage 2 (`scannet_scene_synthesis.py:174-232`): supporters drop
    to the ground; supported-class objects snap onto the nearest
    supporter whose MER contains them, else the ground (with the
    lamp>1.2m / sink dangling exception). Returns (placements,
    stage_map {supporter_id: [supported ids]})."""
    ground_z = (float(np.mean(floor_points[:, 2]))
                if len(floor_points) else 0.0)
    stage_map = {}
    for oid, pl in placements.items():
        if pl.is_supporter:
            stage_map[oid] = []
            zmin = pl.scale[2] * pl.shape.points[:, 2].min()
            old_z = pl.position[2]
            pl.position[2] = ground_z - zmin
            pl.support_height += pl.position[2] - old_z
    for oid, pl in placements.items():
        if pl.is_supporter:
            continue
        name = pl.obj.class_name
        x, y, z = pl.position
        chosen = -1
        best_d2 = np.inf
        if name in SUPPORTED_CLASSES:
            for sid in stage_map:
                mer = placements[sid].support_mer
                d2 = (x - mer[0][0]) ** 2 + (y - mer[0][1]) ** 2
                if _point_in_mer(x, y, mer) and d2 < best_d2:
                    chosen, best_d2 = sid, d2
        zmin = pl.scale[2] * pl.shape.points[:, 2].min()
        if chosen == -1:
            if (name == "lamp" and z > 1.2) or name == "sink":
                pass  # dangling objects keep their height
            else:
                pl.position[2] = ground_z - zmin
        else:
            stage_map[chosen].append(oid)
            pl.position[2] = placements[chosen].support_height - zmin
    return placements, stage_map


def _min_dist2(a, b) -> float:
    """Blockwise min pairwise squared distance."""
    best = np.inf
    for i in range(0, len(a), 2048):
        d = (np.sum(a[i:i + 2048] ** 2, 1)[:, None]
             + np.sum(b**2, 1)[None] - 2 * a[i:i + 2048] @ b.T)
        best = min(best, float(d.min()))
    return max(best, 0.0)


def collision_aware_positions(placements, stage_map, floor_points,
                              threshold=0.05, max_iters=200):
    """Stage 3 (`scannet_scene_synthesis.py:272-385`): center-out sweep
    over ground objects; colliding objects are pushed along the sum of
    1/delta repulsion vectors in 0.1m steps; then a per-supporter pass
    for supported objects (0.05m steps with a centering correction)."""
    ds = {oid: place_points(pl, stride=5)
          for oid, pl in placements.items()}
    dxy = {oid: np.zeros(2) for oid in placements}
    if len(floor_points):
        center = [(floor_points[:, 0].min() + floor_points[:, 0].max())
                  / 2,
                  (floor_points[:, 1].min() + floor_points[:, 1].max())
                  / 2]
    else:
        center = [0.0, 0.0]

    def collides(a_id, b_id):
        return _min_dist2(ds[a_id], ds[b_id]) < threshold**2

    stage1 = sorted(
        stage_map.keys() | {
            oid for oid, pl in placements.items()
            if not pl.is_supporter and not any(
                oid in v for v in stage_map.values())
        },
        key=lambda oid: np.hypot(
            placements[oid].position[0] - center[0],
            placements[oid].position[1] - center[1]))
    for i, oid in enumerate(stage1[1:], start=1):
        consider = stage1[:i]
        x, y = placements[oid].position[0:2]
        move = np.zeros(2)
        hit = False
        for cid in consider:
            cx, cy = placements[cid].position[0:2]
            move[0] += 1.0 / (x - cx) if x != cx else 10.0
            move[1] += 1.0 / (y - cy) if y != cy else 10.0
            hit = hit or collides(oid, cid)
        norm = np.hypot(*move)
        if norm > 0:
            move *= 0.1 / norm
        iters = 0
        while hit and iters < max_iters:
            ds[oid][:, 0:2] += move
            dxy[oid] += move
            hit = any(collides(oid, cid) for cid in consider)
            iters += 1

    # supported objects follow their supporter, then spread on its top
    for sid, kids in stage_map.items():
        for kid in kids:
            ds[kid][:, 0:2] += dxy[sid]
            dxy[kid] += dxy[sid]
        if len(kids) <= 1:
            continue
        s_center = placements[sid].position[0:2]
        order = sorted(
            kids,
            key=lambda oid: -np.hypot(
                placements[oid].position[0] - s_center[0],
                placements[oid].position[1] - s_center[1]))
        for i, oid in enumerate(order[1:], start=1):
            consider = order[:i]
            x, y = placements[oid].position[0:2]
            move = np.zeros(2)
            max_len = 0.0
            hit = False
            for cid in consider:
                cx, cy = placements[cid].position[0:2]
                ex = (x - cx) if x != cx else 0.1
                ey = (y - cy) if y != cy else 0.1
                max_len = max(max_len, np.hypot(1 / ex, 1 / ey))
                move += [1 / ex, 1 / ey]
                hit = hit or collides(oid, cid)
            to_center = np.array([s_center[0] - x, s_center[1] - y])
            nc = np.hypot(*to_center)
            if nc > 0:
                move += max_len / nc * to_center
            norm = np.hypot(*move)
            if norm > 0:
                move *= 0.05 / norm
            iters = 0
            while hit and iters < max_iters:
                ds[oid][:, 0:2] += move
                dxy[oid] += move
                hit = any(collides(oid, cid) for cid in consider)
                iters += 1

    for oid, pl in placements.items():
        pl.position[0] += dxy[oid][0]
        pl.position[1] += dxy[oid][1]
    return placements


def hidden_point_removal(xyz: np.ndarray, camera, radius_factor=100.0):
    """Katz et al. spherical-flip visibility (open3d's
    `hidden_point_removal` equivalent). Returns visible indices."""
    from scipy.spatial import ConvexHull

    cam = np.asarray(camera, dtype=np.float64)
    p = xyz - cam
    norm = np.linalg.norm(p, axis=1, keepdims=True)
    R = norm.max() * radius_factor
    flipped = p + 2 * (R - norm) * (p / np.maximum(norm, 1e-12))
    pts = np.concatenate([flipped, np.zeros((1, 3))])
    hull = ConvexHull(pts)
    visible = np.unique(hull.vertices)
    return visible[visible < len(xyz)]


def export_scene(placements, floor_points=None, *, density=True,
                 hpr=False, rotated_boxes=False, camera_height=2.0):
    """Compose the final scan (`export_for_md40`,
    `scannet_scene_synthesis.py:446-531`).

    Returns (verts (N,3), sem_label (N,), ins_label (N,),
    bbox (K,7|8)): AABB labels (cx,cy,cz,dx,dy,dz,modelnet_id) or, for
    rotated_boxes (matterport), (cx,cy,cz,long,short,dz,angle,id) via
    the footprint MER."""
    # density: per-object point budget proportional to its dominant
    # surface area (`:454-463`)
    s_vals = {}
    for oid, pl in placements.items():
        dx, dy, dz = pl.shape.extents * pl.scale
        s_vals[oid] = dx * dy * dz / max(min(dx, dy, dz), 1e-9)
    s_max = max(s_vals.values()) if s_vals else 1.0

    pts_list, ins_list = [], []
    for oid, pl in placements.items():
        stride = 1
        if density:
            stride = max(int(1 // max(s_vals[oid] / s_max, 1e-3)), 1)
        pts = place_points(pl, stride=stride)
        pts_list.append(pts)
        ins_list.append(np.full(len(pts), oid, dtype=np.int64))
    if floor_points is not None and len(floor_points):
        pts_list.append(floor_points[:, 0:3])
        ins_list.append(np.zeros(len(floor_points), dtype=np.int64))
    xyz = np.concatenate(pts_list)
    ins = np.concatenate(ins_list)

    if hpr:
        xs, ys = xyz[:, 0], xyz[:, 1]
        dx3 = (xs.max() - xs.min()) / 3
        dy3 = (ys.max() - ys.min()) / 3
        keep = set()
        for cx in (xs.min() + dx3, xs.min() + 2 * dx3):
            for cy in (ys.min() + dy3, ys.min() + 2 * dy3):
                keep.update(hidden_point_removal(
                    xyz, [cx, cy, camera_height]).tolist())
        keep = np.asarray(sorted(keep))
        xyz, ins = xyz[keep], ins[keep]

    bboxes = []
    sem = np.zeros(len(ins), dtype=np.int64)
    for oid, pl in placements.items():
        mask = ins == oid
        if not mask.any():
            continue
        obj_xyz = xyz[mask]
        sem_label = MDN_DICT[pl.obj.class_name]
        sem[mask] = sem_label
        mins, maxs = obj_xyz.min(0), obj_xyz.max(0)
        if rotated_boxes:
            (cx, cy), (long, short), theta = mer_canonical(
                min_area_rect(obj_xyz[:, 0:2]))
            bboxes.append([
                cx, cy, (mins[2] + maxs[2]) / 2, long, short,
                maxs[2] - mins[2], np.radians(theta), sem_label])
        else:
            bboxes.append([
                *((mins + maxs) / 2), *(maxs - mins), sem_label])
    return xyz, sem, ins, np.asarray(bboxes, dtype=np.float64)


def synthesize_scene(objects, library, class_avg_dims, rng,
                     floor_points=None, *, rotated_boxes=False,
                     density=True, hpr=False):
    """Full pipeline for one scene; returns the npy-quadruple arrays."""
    if floor_points is None:
        floor_points = np.zeros((0, 3))
    placements = generate_initial_positions(
        objects, library, class_avg_dims, rng)
    placements, stage_map = gravity_aware_positions(
        placements, floor_points)
    placements = collision_aware_positions(
        placements, stage_map, floor_points)
    return export_scene(placements, floor_points, density=density,
                        hpr=hpr, rotated_boxes=rotated_boxes)


def write_scene(out_dir, scan_name, verts, sem, ins, bboxes,
                rgb=None):
    """Write the npy quadruple in the detection-dataset format."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if rgb is None:
        rgb = np.zeros_like(verts)
    np.save(out / f"{scan_name}_vert.npy",
            np.concatenate([verts, rgb], 1).astype(np.float32))
    np.save(out / f"{scan_name}_sem_label.npy", sem)
    np.save(out / f"{scan_name}_ins_label.npy", ins)
    np.save(out / f"{scan_name}_bbox.npy", bboxes)
