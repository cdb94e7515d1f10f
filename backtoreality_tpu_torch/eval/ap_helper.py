"""AP evaluation glue (`detection/Votenet/models/ap_helper.py:63-301`).

`parse_predictions`: decode proposals to oriented corner boxes
(vectorized — no per-proposal python loops), optional empty-box removal,
NMS (2D / 3D / 3D-per-class), then per-class proposal expansion.
`parse_groundtruths` and `APCalculator` accumulate scan-level lists and
compute VOC AP/AR per class.

All inputs are host numpy arrays (convert jax outputs with np.asarray
at the epoch boundary).
"""

import numpy as np

from backtoreality_tpu_torch.eval.box3d import (
    flip_axis_to_camera,
    flip_axis_to_depth,
    get_3d_box_batch,
    get_iou_obb,
)
from backtoreality_tpu_torch.eval.eval_det import eval_det
from backtoreality_tpu_torch.eval.nms import (
    nms_2d_faster,
    nms_3d_faster,
    nms_3d_faster_samecls,
)


def softmax(x):
    probs = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return probs / np.sum(probs, axis=-1, keepdims=True)


def _vectorized_class2angle(config, cls, residual):
    """Vectorized DatasetConfig.class2angle (label format)."""
    if config.num_heading_bin == 1:
        return np.zeros_like(residual)
    per = 2 * np.pi / config.num_heading_bin
    angle = cls.astype(np.float64) * per + residual
    return np.where(angle > np.pi, angle - 2 * np.pi, angle)


def _in_hull(p, hull_points):
    from scipy.spatial import Delaunay

    return Delaunay(hull_points).find_simplex(p) >= 0


def parse_predictions(end_points, config_dict, prefix=""):
    """Returns batch_pred_map_cls: per scan, a list of
    (class, (8,3) corners, score).

    With a `prefix` (GF per-head eval, GF `ap_helper.py:69-207`), keys
    are read as f'{prefix}center' etc. and objectness is a single
    sigmoid logit instead of a 2-way softmax."""
    cfg = config_dict["dataset_config"]
    pred_center = np.asarray(end_points[f"{prefix}center"])  # (B, K, 3)
    heading_scores = np.asarray(end_points[f"{prefix}heading_scores"])
    heading_residuals = np.asarray(
        end_points[f"{prefix}heading_residuals"])
    size_scores = np.asarray(end_points[f"{prefix}size_scores"])
    size_residuals = np.asarray(end_points[f"{prefix}size_residuals"])
    sem_cls_scores = np.asarray(end_points[f"{prefix}sem_cls_scores"])
    obj_logits = np.asarray(end_points[f"{prefix}objectness_scores"])

    bsize, K = pred_center.shape[:2]
    pred_heading_class = np.argmax(heading_scores, -1)  # (B, K)
    pred_heading_residual = np.take_along_axis(
        heading_residuals, pred_heading_class[..., None], axis=2)[..., 0]
    pred_size_class = np.argmax(size_scores, -1)
    pred_size_residual = np.take_along_axis(
        size_residuals, pred_size_class[..., None, None], axis=2)[:, :, 0]
    pred_sem_cls = np.argmax(sem_cls_scores, -1)
    sem_cls_probs = softmax(sem_cls_scores)
    if obj_logits.shape[-1] == 1:
        obj_prob = 1.0 / (1.0 + np.exp(-obj_logits[:, :, 0]))
    else:
        obj_prob = softmax(obj_logits)[:, :, 1]

    # Vectorized decode (replaces `ap_helper.py:99-106` python loop)
    heading_angle = _vectorized_class2angle(
        cfg, pred_heading_class, pred_heading_residual)
    box_size = cfg.mean_size_arr[pred_size_class] + pred_size_residual
    center_cam = flip_axis_to_camera(pred_center)
    pred_corners = get_3d_box_batch(box_size, heading_angle, center_cam)

    nonempty_box_mask = np.ones((bsize, K), dtype=bool)
    if config_dict.get("remove_empty_box"):
        batch_pc = np.asarray(end_points["point_clouds"])[:, :, 0:3]
        for i in range(bsize):
            for j in range(K):
                box3d = flip_axis_to_depth(pred_corners[i, j])
                if np.sum(_in_hull(batch_pc[i], box3d)) < 5:
                    nonempty_box_mask[i, j] = False

    pred_mask = np.zeros((bsize, K), dtype=bool)
    xyz_min = pred_corners.min(axis=2)  # (B, K, 3) over corners
    xyz_max = pred_corners.max(axis=2)
    for i in range(bsize):
        keep = np.nonzero(nonempty_box_mask[i])[0]
        if keep.size == 0:
            continue
        if not config_dict["use_3d_nms"]:
            boxes = np.stack(
                [xyz_min[i, keep, 0], xyz_min[i, keep, 2],
                 xyz_max[i, keep, 0], xyz_max[i, keep, 2],
                 obj_prob[i, keep]], axis=1)
            pick = nms_2d_faster(boxes, config_dict["nms_iou"],
                                 config_dict["use_old_type_nms"])
        elif not config_dict["cls_nms"]:
            boxes = np.concatenate(
                [xyz_min[i, keep], xyz_max[i, keep],
                 obj_prob[i, keep, None]], axis=1)
            pick = nms_3d_faster(boxes, config_dict["nms_iou"],
                                 config_dict["use_old_type_nms"])
        else:
            boxes = np.concatenate(
                [xyz_min[i, keep], xyz_max[i, keep],
                 obj_prob[i, keep, None],
                 pred_sem_cls[i, keep, None]], axis=1)
            pick = nms_3d_faster_samecls(boxes, config_dict["nms_iou"],
                                         config_dict["use_old_type_nms"])
        assert len(pick) > 0
        pred_mask[i, keep[pick]] = True

    conf_thresh = config_dict["conf_thresh"]
    batch_pred_map_cls = []
    for i in range(bsize):
        sel = np.nonzero(pred_mask[i] & (obj_prob[i] > conf_thresh))[0]
        if config_dict["per_class_proposal"]:
            cur = []
            for ii in range(cfg.num_class):
                cur += [
                    (ii, pred_corners[i, j],
                     sem_cls_probs[i, j, ii] * obj_prob[i, j])
                    for j in sel
                ]
            batch_pred_map_cls.append(cur)
        else:
            batch_pred_map_cls.append(
                [(int(pred_sem_cls[i, j]), pred_corners[i, j],
                  obj_prob[i, j]) for j in sel])
    return batch_pred_map_cls


def parse_groundtruths(end_points, config_dict):
    """Returns batch_gt_map_cls: per scan, a list of (class, corners)."""
    cfg = config_dict["dataset_config"]
    center_label = np.asarray(end_points["center_label"])
    heading_class_label = np.asarray(end_points["heading_class_label"])
    heading_residual_label = np.asarray(
        end_points["heading_residual_label"])
    size_class_label = np.asarray(end_points["size_class_label"])
    size_residual_label = np.asarray(end_points["size_residual_label"])
    box_label_mask = np.asarray(end_points["box_label_mask"])
    sem_cls_label = np.asarray(end_points["sem_cls_label"])

    heading_angle = _vectorized_class2angle(
        cfg, heading_class_label, heading_residual_label)
    box_size = cfg.mean_size_arr[size_class_label.astype(int)] \
        + size_residual_label
    center_cam = flip_axis_to_camera(center_label[:, :, 0:3])
    gt_corners = get_3d_box_batch(box_size, heading_angle, center_cam)

    batch_gt_map_cls = []
    for i in range(center_label.shape[0]):
        batch_gt_map_cls.append(
            [(int(sem_cls_label[i, j]), gt_corners[i, j])
             for j in range(center_label.shape[1])
             if box_label_mask[i, j] == 1])
    return batch_gt_map_cls


class APCalculator:
    """Accumulates scan-level predictions/GT, computes per-class AP/AR."""

    def __init__(self, ap_iou_thresh=0.25, class2type_map=None,
                 num_workers: int = 0):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.num_workers = num_workers
        self.reset()

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for pred, gt in zip(batch_pred_map_cls, batch_gt_map_cls):
            self.pred_map_cls[self.scan_cnt] = pred
            self.gt_map_cls[self.scan_cnt] = gt
            self.scan_cnt += 1

    def compute_metrics(self):
        rec, _, ap = eval_det(
            self.pred_map_cls, self.gt_map_cls,
            ovthresh=self.ap_iou_thresh, get_iou_func=get_iou_obb,
            num_workers=self.num_workers)
        ret = {}
        for key in sorted(ap.keys()):
            clsname = (self.class2type_map[key]
                       if self.class2type_map else str(key))
            ret[f"{clsname} Average Precision"] = ap[key]
        ret["mAP"] = np.mean(list(ap.values())) if ap else 0.0
        rec_list = []
        for key in sorted(ap.keys()):
            clsname = (self.class2type_map[key]
                       if self.class2type_map else str(key))
            try:
                ret[f"{clsname} Recall"] = rec[key][-1]
                rec_list.append(rec[key][-1])
            except (TypeError, IndexError):
                ret[f"{clsname} Recall"] = 0
                rec_list.append(0)
        ret["AR"] = np.mean(rec_list) if rec_list else 0.0
        return ret

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0
