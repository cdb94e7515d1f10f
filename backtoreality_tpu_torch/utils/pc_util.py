"""Point-cloud IO and geometry helpers
(`detection/Votenet/utils/pc_util.py` equivalents, trimesh-free).

PLY writing is done directly (ascii), oriented boxes are emitted as
corner meshes, and the sampling/rotation helpers live in
`data.dataset` (random_sampling, rotz) / `eval.box3d` (roty).
"""

from __future__ import annotations

import numpy as np


def write_ply(points: np.ndarray, filename):
    """(N, 3) points -> ascii PLY (`pc_util.py:201-206`)."""
    points = np.asarray(points)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def write_ply_rgb(points: np.ndarray, colors: np.ndarray, filename):
    """(N,3) points + (N,3) uint8 colors -> ascii PLY
    (`pc_util.py:229-241`)."""
    points = np.asarray(points)
    colors = np.asarray(colors).astype(np.uint8)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def write_ply_color(points: np.ndarray, labels: np.ndarray, filename,
                    num_classes: int | None = None):
    """Color points by integer label (`pc_util.py:208-227`)."""
    labels = np.asarray(labels).astype(int)
    num_classes = num_classes or (labels.max() + 1)
    rng = np.random.default_rng(0)
    palette = (rng.random((max(num_classes, 1), 3)) * 255).astype(
        np.uint8)
    write_ply_rgb(points, palette[labels % num_classes], filename)


def point_cloud_to_bbox(points: np.ndarray) -> np.ndarray:
    """AABB [cx, cy, cz, dx, dy, dz] of a cloud (`pc_util.py:346-356`)."""
    mins, maxs = points.min(0), points.max(0)
    return np.concatenate([(mins + maxs) / 2, maxs - mins])


def _box_corners(center, dims, angle=0.0):
    signs = np.array(
        [[1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
         [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]],
        dtype=np.float64)
    corners = signs * np.asarray(dims) / 2
    if angle:
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        corners = corners @ rot.T
    return corners + np.asarray(center)


_BOX_FACES = [
    (0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6),
    (0, 4, 5), (0, 5, 1), (1, 5, 6), (1, 6, 2),
    (2, 6, 7), (2, 7, 3), (3, 7, 4), (3, 4, 0),
]


def _write_box_mesh(boxes_corners, filename):
    n_boxes = len(boxes_corners)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {8 * n_boxes}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {12 * n_boxes}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for corners in boxes_corners:
            for p in corners:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for b in range(n_boxes):
            for face in _BOX_FACES:
                idx = [b * 8 + v for v in face]
                f.write(f"3 {idx[0]} {idx[1]} {idx[2]}\n")


def write_bbox(scene_bbox: np.ndarray, filename):
    """(K, 6) [cx,cy,cz,dx,dy,dz] axis-aligned boxes -> PLY mesh
    (`pc_util.py:358-387`)."""
    corners = [_box_corners(b[0:3], b[3:6]) for b in scene_bbox]
    _write_box_mesh(corners, filename)


def write_oriented_bbox(scene_bbox: np.ndarray, filename):
    """(K, 7) [cx,cy,cz,dx,dy,dz,heading] z-rotated boxes -> PLY mesh
    (`pc_util.py:389-425`)."""
    corners = [_box_corners(b[0:3], b[3:6], b[6]) for b in scene_bbox]
    _write_box_mesh(corners, filename)


def bbox_corner_dist_measure(crnr1: np.ndarray, crnr2: np.ndarray
                             ) -> float:
    """1 - normalized mean corner distance (`pc_util.py:323-343`)."""
    dist = np.mean(np.linalg.norm(crnr1 - crnr2, axis=1))
    diag1 = np.linalg.norm(crnr1[0] - crnr1[6])
    diag2 = np.linalg.norm(crnr2[0] - crnr2[6])
    return 1.0 - dist / max((diag1 + diag2) / 2, 1e-9)
