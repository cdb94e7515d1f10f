"""3D box geometry: corner computation and IoU.

Replaces `detection/Votenet/utils/box_util.py` with vectorized numpy.
Conventions preserved exactly (they define the evaluation protocol):

* boxes are computed in "upright camera" coords (x right, y down,
  z forward); detection outputs are flipped from depth coords first;
* `get_3d_box(box_size, heading_angle, center)` emits 8 corners with
  the top face at rows 0-3 and bottom at 4-7, rotated by `roty`;
* `box3d_iou` = (BEV convex polygon intersection x height overlap) /
  union. The BEV rectangles' corner order (rows 3..0 of (x, z)) is
  counter-clockwise, as the clipping requires.
"""

import numpy as np


def flip_axis_to_camera(pc: np.ndarray) -> np.ndarray:
    """Depth (x right, y forward, z up) -> camera (x right, y down,
    z forward)."""
    pc2 = np.copy(pc)
    pc2[..., [0, 1, 2]] = pc2[..., [0, 2, 1]]
    pc2[..., 1] *= -1
    return pc2


def flip_axis_to_depth(pc: np.ndarray) -> np.ndarray:
    pc2 = np.copy(pc)
    pc2[..., [0, 2, 1]] = pc2[..., [0, 1, 2]]
    pc2[..., 2] *= -1
    return pc2


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def roty_batch(t: np.ndarray) -> np.ndarray:
    """(...,) -> (..., 3, 3)."""
    out = np.zeros(t.shape + (3, 3))
    c, s = np.cos(t), np.sin(t)
    out[..., 0, 0] = c
    out[..., 0, 2] = s
    out[..., 1, 1] = 1
    out[..., 2, 0] = -s
    out[..., 2, 2] = c
    return out


_CORNER_SIGNS_X = np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float64)
_CORNER_SIGNS_Y = np.array([1, 1, 1, 1, -1, -1, -1, -1], dtype=np.float64)
_CORNER_SIGNS_Z = np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float64)


def get_3d_box(box_size, heading_angle, center) -> np.ndarray:
    """(l,w,h), angle, (3,) -> (8, 3) corners in camera coords."""
    return get_3d_box_batch(
        np.asarray(box_size, dtype=np.float64)[None],
        np.asarray([heading_angle], dtype=np.float64),
        np.asarray(center, dtype=np.float64)[None],
    )[0]


def get_3d_box_batch(box_size, heading_angle, center) -> np.ndarray:
    """Vectorized corner computation.

    box_size (..., 3) as (l, w, h); heading_angle (...); center (..., 3).
    Returns (..., 8, 3). Replaces the reference's per-(i,j) python loop
    (`ap_helper.py:99-106`) — this is one of the host-side hot loops.
    """
    box_size = np.asarray(box_size, dtype=np.float64)
    heading_angle = np.asarray(heading_angle, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    l = box_size[..., 0:1] / 2
    w = box_size[..., 1:2] / 2
    h = box_size[..., 2:3] / 2
    corners = np.stack(
        [
            l * _CORNER_SIGNS_X,  # x: +-l/2
            h * _CORNER_SIGNS_Y,  # y: +-h/2 (camera up axis)
            w * _CORNER_SIGNS_Z,  # z: +-w/2
        ],
        axis=-1,
    )  # (..., 8, 3)
    R = roty_batch(heading_angle)  # (..., 3, 3)
    corners = np.einsum("...ij,...kj->...ki", R, corners)
    return corners + center[..., None, :]


def _poly_area(poly: np.ndarray) -> float:
    """Shoelace area of an ordered polygon (K, 2)."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _clip_polygon(subject: np.ndarray, clip: np.ndarray):
    """Sutherland-Hodgman: clip `subject` by convex CCW polygon `clip`.

    Returns the intersection polygon as an (K, 2) array or None if
    empty. Differs from the reference's rosetta-code version in two
    robustness details: boundary points count as inside (non-strict
    test, so identical/touching boxes clip to themselves), and
    near-parallel edge intersections are skipped instead of producing
    garbage coordinates.
    """
    output = [tuple(p) for p in subject]
    cp1 = tuple(clip[-1])
    for cp2 in map(tuple, clip):
        if not output:
            return None
        input_list, output = output, []
        ex, ey = cp2[0] - cp1[0], cp2[1] - cp1[1]

        def is_inside(p):
            return ex * (p[1] - cp1[1]) >= ey * (p[0] - cp1[0])

        s = input_list[-1]
        for e in input_list:
            if is_inside(e):
                if not is_inside(s):
                    pt = _line_intersect(cp1, cp2, s, e)
                    if pt is not None:
                        output.append(pt)
                output.append(e)
            elif is_inside(s):
                pt = _line_intersect(cp1, cp2, s, e)
                if pt is not None:
                    output.append(pt)
            s = e
        cp1 = cp2
    if not output:
        return None
    return np.asarray(output)


def _line_intersect(a1, a2, b1, b2):
    dc = (a1[0] - a2[0], a1[1] - a2[1])
    dp = (b1[0] - b2[0], b1[1] - b2[1])
    denom = dc[0] * dp[1] - dc[1] * dp[0]
    if abs(denom) < 1e-12:
        return None
    n1 = a1[0] * a2[1] - a1[1] * a2[0]
    n2 = b1[0] * b2[1] - b1[1] * b2[0]
    n3 = 1.0 / denom
    return ((n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3)


def box3d_vol(corners: np.ndarray) -> float:
    a = np.linalg.norm(corners[0] - corners[1])
    b = np.linalg.norm(corners[1] - corners[2])
    c = np.linalg.norm(corners[0] - corners[4])
    return a * b * c


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray):
    """3D IoU of two corner boxes (camera coords, get_3d_box order).

    Returns (iou3d, iou2d_bev)."""
    rect1 = corners1[3::-1][:, (0, 2)]  # rows 3..0 -> CCW BEV polygon
    rect2 = corners2[3::-1][:, (0, 2)]
    area1 = _poly_area(rect1)
    area2 = _poly_area(rect2)
    inter = _clip_polygon(rect1, rect2)
    if inter is None:
        inter_area = 0.0
    else:
        # Degenerate clips (identical/touching boxes) can emit out-of-order
        # or duplicate vertices; the hull area is robust to that.
        from scipy.spatial import ConvexHull, QhullError

        try:
            inter_area = ConvexHull(inter).volume
        except QhullError:
            inter_area = 0.0
    iou_2d = inter_area / max(area1 + area2 - inter_area, 1e-12)
    ymax = min(corners1[0, 1], corners2[0, 1])
    ymin = max(corners1[4, 1], corners2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol1 = box3d_vol(corners1)
    vol2 = box3d_vol(corners2)
    iou = inter_vol / max(vol1 + vol2 - inter_vol, 1e-12)
    return iou, iou_2d


def get_iou_obb(bb1, bb2) -> float:
    return box3d_iou(bb1, bb2)[0]


def eval_det_precision_recall(pred_boxes, gt_boxes, iou_thresh=0.25,
                              iou_func=None) -> tuple[float, float]:
    """Scene-level precision/recall by greedy IoU matching
    (`utils/metric_util.py` multi_scene_precision_recall core).

    pred_boxes / gt_boxes: lists of axis-aligned [xmin..zmax] boxes."""
    iou_func = iou_func or axis_aligned_iou
    matched_gt = set()
    tp = 0
    for pb in pred_boxes:
        best, best_j = 0.0, -1
        for j, gb in enumerate(gt_boxes):
            if j in matched_gt:
                continue
            iou = iou_func(pb, gb)
            if iou > best:
                best, best_j = iou, j
        if best >= iou_thresh:
            tp += 1
            matched_gt.add(best_j)
    precision = tp / max(len(pred_boxes), 1)
    recall = tp / max(len(gt_boxes), 1)
    return precision, recall


def axis_aligned_iou(box_a, box_b) -> float:
    """IoU of two axis-aligned boxes given as [xmin,ymin,zmin,xmax,ymax,
    zmax] (`utils/metric_util.py` calc_iou)."""
    max_a = np.asarray(box_a[3:6])
    max_b = np.asarray(box_b[3:6])
    min_max = np.minimum(max_a, max_b)
    min_a = np.asarray(box_a[0:3])
    min_b = np.asarray(box_b[0:3])
    max_min = np.maximum(min_a, min_b)
    if not (min_max > max_min).all():
        return 0.0
    intersection = float(np.prod(min_max - max_min))
    vol_a = float(np.prod(max_a - min_a))
    vol_b = float(np.prod(max_b - min_b))
    return intersection / (vol_a + vol_b - intersection)
