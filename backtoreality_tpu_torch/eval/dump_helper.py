"""PLY result dumps for visual debugging
(`detection/Votenet/models/dump_helper.py:24-141`).

Writes per-scene PLYs of the input cloud, seeds, votes, proposal
centers (all / objectness-confident / NMS-surviving), predicted and GT
boxes. Inputs are host numpy end_points (model outputs + labels).
"""

from __future__ import annotations

import os

import numpy as np

from backtoreality_tpu_torch.eval.ap_helper import softmax
from backtoreality_tpu_torch.utils.pc_util import (
    write_oriented_bbox,
    write_ply,
)

DUMP_CONF_THRESH = 0.5  # (`dump_helper.py:20`)


def dump_results(end_points, dump_dir, config, inference_switch=False):
    os.makedirs(dump_dir, exist_ok=True)
    point_clouds = np.asarray(end_points["point_clouds"])
    batch_size = point_clouds.shape[0]

    seed_xyz = np.asarray(end_points["seed_xyz"])
    has_votes = "vote_xyz" in end_points
    if has_votes:
        vote_xyz = np.asarray(end_points["vote_xyz"])
        aggregated_vote_xyz = np.asarray(
            end_points["aggregated_vote_xyz"])
    objectness_scores = np.asarray(end_points["objectness_scores"])
    pred_center = np.asarray(end_points["center"])
    heading_scores = np.asarray(end_points["heading_scores"])
    heading_residuals = np.asarray(end_points["heading_residuals"])
    size_scores = np.asarray(end_points["size_scores"])
    size_residuals = np.asarray(end_points["size_residuals"])
    pred_mask = np.asarray(end_points.get(
        "pred_mask", np.ones(pred_center.shape[:2])))

    pred_heading_class = np.argmax(heading_scores, -1)
    pred_heading_residual = np.take_along_axis(
        heading_residuals, pred_heading_class[..., None], axis=2)[..., 0]
    pred_size_class = np.argmax(size_scores, -1)
    pred_size_residual = np.take_along_axis(
        size_residuals, pred_size_class[..., None, None], axis=2)[:, :, 0]

    for i in range(batch_size):
        pc = point_clouds[i, :, 0:3]
        objectness_prob = softmax(objectness_scores[i])[:, 1]

        write_ply(pc, os.path.join(dump_dir, f"{i:06d}_pc.ply"))
        write_ply(seed_xyz[i],
                  os.path.join(dump_dir, f"{i:06d}_seed_pc.ply"))
        if has_votes:
            write_ply(vote_xyz[i],
                      os.path.join(dump_dir, f"{i:06d}_vgen_pc.ply"))
            write_ply(
                aggregated_vote_xyz[i],
                os.path.join(dump_dir, f"{i:06d}_aggregated_vote_pc.ply"))
        write_ply(pred_center[i],
                  os.path.join(dump_dir, f"{i:06d}_proposal_pc.ply"))
        if np.sum(objectness_prob > DUMP_CONF_THRESH) > 0:
            write_ply(
                pred_center[i, objectness_prob > DUMP_CONF_THRESH],
                os.path.join(dump_dir,
                             f"{i:06d}_confident_proposal_pc.ply"))
            # predicted boxes (confident + NMS-surviving)
            num_proposal = pred_center.shape[1]
            obbs = []
            for j in range(num_proposal):
                obb = config.param2obb(
                    pred_center[i, j], pred_heading_class[i, j],
                    pred_heading_residual[i, j], pred_size_class[i, j],
                    pred_size_residual[i, j])
                obbs.append(obb)
            obbs = np.asarray(obbs)
            sel = (objectness_prob > DUMP_CONF_THRESH) \
                & (pred_mask[i] == 1)
            if sel.any():
                write_oriented_bbox(
                    obbs[sel],
                    os.path.join(dump_dir,
                                 f"{i:06d}_pred_confident_nms_bbox.ply"))

    if "center_label" not in end_points or inference_switch:
        return

    center_label = np.asarray(end_points["center_label"])
    heading_class_label = np.asarray(end_points["heading_class_label"])
    heading_residual_label = np.asarray(
        end_points["heading_residual_label"])
    size_class_label = np.asarray(end_points["size_class_label"])
    size_residual_label = np.asarray(end_points["size_residual_label"])
    box_label_mask = np.asarray(end_points["box_label_mask"])
    for i in range(batch_size):
        obbs = []
        for j in range(center_label.shape[1]):
            if box_label_mask[i, j] == 0:
                continue
            obbs.append(config.param2obb(
                center_label[i, j], int(heading_class_label[i, j]),
                heading_residual_label[i, j],
                int(size_class_label[i, j]),
                size_residual_label[i, j]))
        if obbs:
            write_oriented_bbox(
                np.asarray(obbs),
                os.path.join(dump_dir, f"{i:06d}_gt_bbox.ply"))
