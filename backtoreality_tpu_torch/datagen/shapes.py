"""Shape analysis: minimum-enclosing rectangles, support surfaces,
supportability.

Re-design of `data_generation/ScanNet/modelnet40_tools.py:14-116` and
the `get_solid_MER` logic in `scannet_scene_synthesis.py:19-51`.
MER convention matches the reference: ((cx, cy), (long, short), theta)
with theta in degrees, anticlockwise, the angle of the LONG side.

A copy of ``backtoreality_tpu/datagen/shapes.py``, except that
`solid_mer` splits the footprint with `_kmeans2_labels`, a numpy copy of
what ``sklearn.cluster.KMeans(n_clusters=2, n_init=4).fit(xy).labels_``
computes (scikit-learn 1.9.0), in place of the call itself: the port
needs no scikit-learn. Like the call, it draws its k-means++ seeds from
numpy's global ``RandomState``, the same draws in the same order, so
under one ``np.random.seed`` both give one split and leave the state
alike.
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


def _sq_distances(c: np.ndarray, x: np.ndarray,
                  x_norms: np.ndarray) -> np.ndarray:
    """Squared distances (len(c), len(x)) as sklearn's
    ``_euclidean_distances(c, x, Y_norm_squared=x_norms, squared=True)``
    takes them in float64: -2 c.x, plus |c|^2, plus |x|^2, clipped at 0."""
    d = -2 * (c @ x.T)
    d += np.einsum("ij,ij->i", c, c)[:, None]
    d += x_norms[None]
    np.maximum(d, 0, out=d)
    return d


def _kmeans_plusplus2(x: np.ndarray, x_norms: np.ndarray) -> np.ndarray:
    """Two k-means++ seeds (``_kmeans_plusplus``): the first drawn
    uniformly, the second the best of 2 + int(log 2) candidates drawn in
    proportion to the squared distance, from the global RandomState."""
    weight = np.ones(len(x), dtype=x.dtype)
    trials = 2 + int(np.log(2))
    centers = np.empty((2, x.shape[1]), dtype=x.dtype)
    centers[0] = x[np.random.choice(len(x), p=weight / weight.sum())]
    closest = _sq_distances(centers[0, np.newaxis], x, x_norms)
    pot = closest @ weight
    ids = np.searchsorted(np.cumsum(weight * closest),
                          np.random.uniform(size=trials) * pot)
    np.clip(ids, None, closest.size - 1, out=ids)
    to_candidates = _sq_distances(x[ids], x, x_norms)
    np.minimum(closest, to_candidates, out=to_candidates)
    pots = to_candidates @ weight.reshape(-1, 1)
    centers[1] = x[ids[np.argmin(pots)]]
    return centers


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Lloyd's E-step (``_update_chunk_dense``): |c|^2 - 2 x.c, the
    lowest-numbered centre on a tie."""
    norms = np.einsum("ij,ij->i", centers, centers)
    d = norms[None] + -2.0 * (x @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_step(x, centers):
    """One E- and M-step (``lloyd_iter_chunked_dense``): the labels, the
    new centres (each a sum in index order times the reciprocal of its
    weight; an empty cluster takes the point farthest from its centre,
    ``_relocate_empty_clusters_dense``) and each centre's shift."""
    labels = _assign(x, centers)
    clusters = len(centers)
    # bincount adds in index order
    new = np.stack([np.bincount(labels, x[:, j], clusters)
                    for j in range(x.shape[1])], 1)
    weight = np.bincount(labels, minlength=clusters).astype(x.dtype)
    empty = np.flatnonzero(weight == 0)
    if len(empty):
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if dist.max() != 0:
            for k, j in zip(empty, far):
                new[labels[j]] -= x[j]
                new[k] = x[j]
                weight[k] = 1.0
                weight[labels[j]] -= 1.0
    heaviest = np.argmax(weight)
    for k in range(clusters):
        if weight[k] > 0:
            new[k] *= 1.0 / weight[k]
        else:
            new[k] = new[heaviest]
    d = new - centers
    shift = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    return labels, new, shift


def _kmeans2_labels(xy: np.ndarray) -> np.ndarray:
    """``KMeans(n_clusters=2, n_init=4).fit(xy).labels_`` (scikit-learn
    1.9.0, ``KMeans.fit`` with Lloyd's algorithm) for float64 (N, 2)
    points, drawing from numpy's global RandomState as it does: the
    tolerance 1e-4 scaled by the mean variance, the data centred on its
    mean, 4 k-means++ seeds in turn, at most 300 Lloyd's iterations each
    until the labels repeat or the centres move within the tolerance
    (then one more E-step), and a later run kept only if its inertia is
    lower and its split differs. scikit-learn sums a cluster over threads
    in any order; this sums in index order, which can move a label only
    for a point within rounding of the two centres' bisector."""
    x = np.array(xy, dtype=np.float64, order="C")
    tol = np.mean(np.var(x, axis=0)) * 1e-4
    x -= x.mean(axis=0)
    x_norms = np.einsum("ij,ij->i", x, x)
    best_labels, best_inertia = None, None
    for _ in range(4):
        centers = _kmeans_plusplus2(x, x_norms)
        labels_old = np.full(len(x), -1, dtype=np.int32)
        strict = False
        for _ in range(300):
            labels, centers, shift = _lloyd_step(x, centers)
            if np.array_equal(labels, labels_old):
                strict = True
                break
            if (shift ** 2).sum() <= tol:
                break
            labels_old = labels
        if not strict:
            labels = _assign(x, centers)
        d = x - centers[labels]
        inertia = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).sum()
        if best_inertia is None or (
                inertia < best_inertia
                and not _same_split(labels, best_labels)):
            best_labels, best_inertia = labels, inertia
    return best_labels


def _same_split(a: np.ndarray, b: np.ndarray) -> bool:
    """Two labellings equal up to a renaming (``_is_same_clustering``)."""
    return bool((a == b).all() or (a != b).all())


def solid_mer(points: np.ndarray):
    """MER robust to L-shaped/thin shapes (`get_solid_MER`,
    `scannet_scene_synthesis.py:19-51`): if a 2-means split shows the
    shape is not "solid", take the MER of the larger cluster."""
    xys = points[:, 0:2]
    rect = min_area_rect(xys)
    label = _kmeans2_labels(xys)
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
