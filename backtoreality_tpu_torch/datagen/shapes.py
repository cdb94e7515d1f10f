"""Shape analysis: minimum-enclosing rectangles, support surfaces,
supportability.

Re-design of `data_generation/ScanNet/modelnet40_tools.py:14-116` and
the `get_solid_MER` logic in `scannet_scene_synthesis.py:19-51`.
MER convention matches the reference: ((cx, cy), (long, short), theta)
with theta in degrees, anticlockwise, the angle of the LONG side.

A copy of ``backtoreality_tpu/datagen/shapes.py``, except that
`solid_mer` splits the footprint with a plain 2-means
(`_two_means_labels`) in place of sklearn's KMeans, so that the port
needs no scikit-learn. The port's fixtures do not use the MER: the synthetic
scans read a shape's points only.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def min_area_rect(xy: np.ndarray):
    """Minimum-area enclosing rectangle of 2D points.

    Returns ((cx, cy), (w, h), angle_deg) in the cv2.minAreaRect
    convention. Uses cv2 when available, else rotating calipers on the
    convex hull."""
    try:
        import cv2

        rect = cv2.minAreaRect(xy.astype(np.float32))
        return ((float(rect[0][0]), float(rect[0][1])),
                (float(rect[1][0]), float(rect[1][1])),
                float(rect[2]))
    except ImportError:
        pass
    from scipy.spatial import ConvexHull

    pts = xy[ConvexHull(xy).vertices]
    n = len(pts)
    best = None
    for i in range(n):
        edge = pts[(i + 1) % n] - pts[i]
        angle = np.arctan2(edge[1], edge[0])
        c, s = np.cos(-angle), np.sin(-angle)
        rot = np.array([[c, -s], [s, c]])
        proj = pts @ rot.T
        lo, hi = proj.min(0), proj.max(0)
        area = np.prod(hi - lo)
        if best is None or area < best[0]:
            center = rot.T @ ((lo + hi) / 2)
            best = (area, (tuple(center), tuple(hi - lo),
                           float(np.degrees(angle) % 90)))
    return best[1]


def mer_canonical(rect):
    """cv2-style rect -> reference MER ((cx,cy),(long,short),theta_long)
    (`scannet_scene_synthesis.py:41-51`)."""
    (cx, cy), (w, h), ang = rect
    if h > w:
        l_s = (h, w)
    else:
        l_s = (w, h)
    if w >= h:
        theta = -ang
        if theta == 0:
            theta = 180
    else:
        theta = -ang + 90
    return ((cx, cy), l_s, theta)


def _two_means_labels(xy: np.ndarray) -> np.ndarray:
    """2-means labels by Lloyd's iterations from the two extremes of the
    principal axis."""
    d = xy - xy.mean(0)
    proj = d @ np.linalg.svd(d, full_matrices=False)[2][0]
    centres = xy[[proj.argmin(), proj.argmax()]]
    for _ in range(100):
        label = ((xy[:, None] - centres[None]) ** 2).sum(-1).argmin(1)
        if label.min() == label.max():
            break
        new = np.stack([xy[label == k].mean(0) for k in range(2)])
        if np.array_equal(new, centres):
            break
        centres = new
    return label


def solid_mer(points: np.ndarray):
    """MER robust to L-shaped/thin shapes (`get_solid_MER`,
    `scannet_scene_synthesis.py:19-51`): if a 2-means split shows the
    shape is not "solid", take the MER of the larger cluster."""
    xys = points[:, 0:2]
    rect = min_area_rect(xys)
    label = _two_means_labels(xys)
    small = xys[label == 0] if (label == 0).sum() < (label == 1).sum() \
        else xys[label == 1]
    other = xys[label == 1] if (label == 0).sum() < (label == 1).sum() \
        else xys[label == 0]
    rect_small = min_area_rect(small)
    is_solid = (rect_small[1][0] * rect_small[1][1] * 2.5
                > rect[1][0] * rect[1][1])
    if not is_solid:
        rect = min_area_rect(other)
    return mer_canonical(rect)


def support_height(points: np.ndarray, rel_tol: float = 0.05) -> float:
    """Height of the top support surface: the highest dense horizontal
    slab (the reference uses surface normals perpendicular to z,
    `modelnet40_tools.py:47-58`; a density slab is normal-free and
    equivalent for tabletop-like shapes)."""
    z = points[:, 2]
    zmin, zmax = z.min(), z.max()
    if zmax - zmin < 1e-6:
        return float(zmax)
    nbins = 40
    hist, edges = np.histogram(z, bins=nbins)
    # search from the top for a slab holding >= rel_tol of the points
    thresh = max(int(rel_tol * len(z)), 1)
    for i in range(nbins - 1, -1, -1):
        if hist[i] >= thresh:
            return float(edges[i + 1])
    return float(zmax)


def is_supportable(points: np.ndarray, min_ratio: float = 0.9) -> bool:
    """Supportability test (`modelnet40_tools.py:70-89`): the top
    surface's hull must cover >= min_ratio of the shape's MER area."""
    from scipy.spatial import ConvexHull, QhullError

    z_top = support_height(points)
    z = points[:, 2]
    slab = points[np.abs(z - z_top) < 0.05 * (z.max() - z.min() + 1e-9)]
    if len(slab) < 8:
        return False
    mer = mer_canonical(min_area_rect(points[:, 0:2]))
    mer_area = mer[1][0] * mer[1][1]
    try:
        hull_area = ConvexHull(slab[:, 0:2]).volume
    except QhullError:
        return False
    return hull_area >= min_ratio * mer_area


@dataclasses.dataclass
class ShapeRecord:
    """One normalized shape in the library.

    points: (M, 3) z-up cloud.
    mer: ((cx,cy),(long,short),theta) of the footprint.
    support_z: top-surface height (shape units).
    supportable: can other objects be placed on it.
    """

    name: str
    points: np.ndarray
    mer: tuple
    support_z: float
    supportable: bool

    @property
    def extents(self) -> np.ndarray:
        return self.points.max(0) - self.points.min(0)

    @property
    def ls_ratio(self) -> float:
        long, short = self.mer[1]
        return long / max(short, 1e-9)


def analyze_shape(name: str, points: np.ndarray) -> ShapeRecord:
    """Build a ShapeRecord (the per-shape `this_class_info` entry,
    `modelnet40_tools.py:92-116`)."""
    return ShapeRecord(
        name=name,
        points=points,
        mer=solid_mer(points),
        support_z=support_height(points),
        supportable=is_supportable(points),
    )
