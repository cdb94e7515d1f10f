"""VOC-style AP evaluation (`detection/Votenet/utils/eval_det.py:24-256`).

Greedy confidence-ordered matching per class, with the exact reference
protocol: a detection is TP iff IoU > threshold with an unmatched GT
(`ovmax > ovthresh`, strict). Per-class work can fan out over a process
pool like the reference's `eval_det_multiprocessing` (Pool(10)).
"""

import logging
import multiprocessing

import numpy as np

logger = logging.getLogger(__name__)

from backtoreality_tpu_torch.eval.box3d import get_iou_obb


def voc_ap(rec, prec, use_07_metric: bool = False) -> float:
    """Area under the precision envelope (VOC)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False,
                 get_iou_func=get_iou_obb):
    """Single-class PR/AP.

    pred: {img_id: [(bbox, score)]}; gt: {img_id: [bbox]}.
    Returns (rec, prec, ap)."""
    class_recs = {}
    npos = 0
    for img_id, boxes in gt.items():
        bbox = np.array(boxes)
        npos += len(bbox)
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
    for img_id in pred:
        if img_id not in class_recs:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, BB = [], [], []
    for img_id, dets in pred.items():
        for box, score in dets:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
    confidence = np.array(confidence)
    BB = np.array(BB)

    sorted_ind = np.argsort(-confidence)
    BB = BB[sorted_ind, ...] if BB.size else BB
    image_ids = [image_ids[i] for i in sorted_ind]

    # Precompute per-image IoU matrices with the native library when the
    # boxes are corner-form (8, 3) and the default OBB IoU is in use —
    # this is the host-side hot loop (python per-pair IoU otherwise). A
    # library that cannot be built raises (`native`): pass another
    # get_iou_func for the Python loop.
    iou_cache = None
    if (get_iou_func is get_iou_obb and BB.size
            and BB.ndim == 3 and BB.shape[1:] == (8, 3)):
        from backtoreality_tpu_torch.eval import native

        iou_cache = {}
        det_rows = {}
        for d, img_id in enumerate(image_ids):
            det_rows.setdefault(img_id, []).append(d)
        for img_id, rows in det_rows.items():
            bbgt = class_recs[img_id]["bbox"]
            if bbgt.size:
                mat = native.box3d_iou_matrix(
                    BB[rows].astype(float), bbgt.astype(float))
                for local, d in enumerate(rows):
                    iou_cache[d] = mat[local]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec_entry = class_recs[image_ids[d]]
        bbgt = rec_entry["bbox"].astype(float)
        ovmax, jmax = -np.inf, -1
        if iou_cache is not None and d in iou_cache:
            ious = iou_cache[d]
            if len(ious):
                jmax = int(np.argmax(ious))
                ovmax = float(ious[jmax])
        else:
            bb = BB[d].astype(float)
            for j in range(bbgt.shape[0]):
                iou = get_iou_func(bb, bbgt[j])
                if iou > ovmax:
                    ovmax, jmax = iou, j
        if ovmax > ovthresh and not rec_entry["det"][jmax]:
            tp[d] = 1.0
            rec_entry["det"][jmax] = True
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def _spawn_safe() -> bool:
    """Spawn workers re-import the parent's __main__; from a REPL /
    stdin script that file doesn't exist and the pool respawn-fails in
    a loop. Fall back to serial evaluation there."""
    import os
    import sys

    main_mod = sys.modules.get("__main__")
    main_file = getattr(main_mod, "__file__", None)
    return main_file is None or os.path.exists(main_file)


def _eval_cls_wrapper(args):
    pred, gt, ovthresh, use_07, get_iou_func = args
    return eval_det_cls(pred, gt, ovthresh, use_07, get_iou_func)


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False,
             get_iou_func=get_iou_obb, num_workers: int = 0):
    """Multi-class AP.

    pred_all: {img_id: [(classname, bbox, score)]}
    gt_all: {img_id: [(classname, bbox)]}
    num_workers > 0 fans per-class evaluation over a process pool
    (reference `eval_det_multiprocessing`, Pool(10)).
    Returns ({cls: rec}, {cls: prec}, {cls: ap})."""
    pred, gt = {}, {}
    for img_id, dets in pred_all.items():
        for classname, bbox, score in dets:
            pred.setdefault(classname, {}).setdefault(img_id, []).append(
                (bbox, score))
    for img_id, gts in gt_all.items():
        for classname, bbox in gts:
            gt.setdefault(classname, {}).setdefault(img_id, []).append(
                bbox)

    classnames = [c for c in gt if c in pred]
    args = [(pred[c], gt[c], ovthresh, use_07_metric, get_iou_func)
            for c in classnames]
    if num_workers > 0 and len(classnames) > 1 and not _spawn_safe():
        logger.info(
            "eval_det: num_workers=%d requested but spawn is unsafe here "
            "(no importable __main__, e.g. a REPL); evaluating serially.",
            num_workers)
    if num_workers > 0 and len(classnames) > 1 and _spawn_safe():
        # spawn, not fork: the parent has live JAX/XLA threads by eval
        # time and forking them risks deadlock (os.fork warning). The
        # workers only import numpy + the native IoU lib, so spawn
        # startup is cheap.
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(num_workers) as pool:
            results = pool.map(_eval_cls_wrapper, args)
    else:
        results = [_eval_cls_wrapper(a) for a in args]

    rec, prec, ap = {}, {}, {}
    for classname, (r, p, a) in zip(classnames, results):
        rec[classname], prec[classname], ap[classname] = r, p, a
    for classname in gt:
        if classname not in pred:
            rec[classname] = 0
            prec[classname] = 0
            ap[classname] = 0
    return rec, prec, ap
