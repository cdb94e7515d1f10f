"""Greedy NMS variants (`detection/Votenet/utils/nms.py:44-173`).

Vectorized per-iteration over surviving candidates; 2D BEV, 3D, and
3D-same-class flavours. `old_type` uses intersection/candidate-area
instead of IoU.
"""

import numpy as np


def _greedy(mins, maxs, score, cls, overlap_threshold, old_type):
    """mins/maxs: (K, D) box extents. cls: (K,) or None."""
    area = np.prod(maxs - mins, axis=1)
    order = np.argsort(score)
    pick = []
    while order.size:
        i = order[-1]
        pick.append(int(i))
        rest = order[:-1]
        lo = np.maximum(mins[i], mins[rest])
        hi = np.minimum(maxs[i], maxs[rest])
        inter = np.prod(np.maximum(0.0, hi - lo), axis=1)
        if old_type:
            o = inter / area[rest]
        else:
            o = inter / (area[i] + area[rest] - inter)
        if cls is not None:
            o = o * (cls[i] == cls[rest])
        order = rest[o <= overlap_threshold]
    return pick


def nms_2d_faster(boxes, overlap_threshold, old_type=False):
    """boxes (K, 5): x1,y1,x2,y2,score."""
    return _greedy(boxes[:, 0:2], boxes[:, 2:4], boxes[:, 4], None,
                   overlap_threshold, old_type)


def nms_3d_faster(boxes, overlap_threshold, old_type=False):
    """boxes (K, 7): x1,y1,z1,x2,y2,z2,score."""
    return _greedy(boxes[:, 0:3], boxes[:, 3:6], boxes[:, 6], None,
                   overlap_threshold, old_type)


def nms_3d_faster_samecls(boxes, overlap_threshold, old_type=False):
    """boxes (K, 8): x1,y1,z1,x2,y2,z2,score,class — only same-class
    pairs suppress each other."""
    return _greedy(boxes[:, 0:3], boxes[:, 3:6], boxes[:, 6],
                   boxes[:, 7], overlap_threshold, old_type)


def nms_crnr_dist(boxes, conf, overlap_threshold):
    """Corner-distance NMS (`utils/nms.py:152-167`): suppress boxes
    whose corner-distance similarity to a kept box exceeds the
    threshold. boxes (K, 8, 3) corners; conf (K,)."""
    from backtoreality_tpu_torch.utils.pc_util import bbox_corner_dist_measure

    order = np.argsort(conf)
    pick = []
    while order.size:
        i = order[-1]
        pick.append(int(i))
        rest = order[:-1]
        scores = np.array([
            bbox_corner_dist_measure(boxes[i], boxes[j]) for j in rest
        ])
        order = rest[scores <= overlap_threshold] if rest.size else rest
    return pick
