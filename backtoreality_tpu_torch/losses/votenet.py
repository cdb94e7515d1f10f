"""VoteNet training criterion, the FSB recipe.

Counterpart of ``backtoreality_tpu/losses/votenet.py`` (reference
`detection/Votenet/models/loss_helper.py`: constants :19-22, vote loss
:24-69, objectness :111-152, box :154-228, composition :336-400). Every
function takes `end_points` (model outputs merged with the GT labels,
channels-last) and `get_loss` returns ``(loss, aux)``, where aux holds
every scalar the reference logs plus the label tensors downstream code
needs. Nothing is mutated. The weak, DA, jitter and boxnet criteria are
not ported.

Label keys (from the data pipeline, the reference's names):
  center_label (B,K2,3), box_label_mask (B,K2), sem_cls_label (B,K2),
  heading_class_label (B,K2), heading_residual_label (B,K2),
  size_class_label (B,K2), size_residual_label (B,K2,3),
  vote_label (B,N,9), vote_label_mask (B,N).
"""

from __future__ import annotations

import math

import torch

from backtoreality_tpu_torch.losses.common import (masked_mean, one_hot_f32,
                                                   softmax_ce)
from backtoreality_tpu_torch.ops import huber_loss, nn_distance

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)


def _take(x, index):
    """take_along_axis on axis 1: x (B, N, ...) by index (B, K)."""
    index = index.long()
    if x.dim() > 2:
        index = index.reshape(index.shape + (1,) * (x.dim() - 2)).expand(
            -1, -1, *x.shape[2:])
    return torch.gather(x, 1, index)


def compute_vote_loss(end_points):
    """`loss_helper.py:24-69`: per-seed min-over-votes min-over-GT-votes
    L1 regression, masked to seeds inside objects."""
    b, num_seed, _ = end_points["seed_xyz"].shape
    vote_xyz = end_points["vote_xyz"]  # (B, num_seed*vf, 3)
    seed_inds = end_points["seed_inds"]

    seed_gt_votes_mask = _take(end_points["vote_label_mask"], seed_inds)
    seed_gt_votes = _take(end_points["vote_label"], seed_inds)  # (B,S,9)
    seed_gt_votes = seed_gt_votes + end_points["seed_xyz"].repeat(
        1, 1, GT_VOTE_FACTOR)

    vote_reshape = vote_xyz.reshape(b * num_seed, -1, 3)
    gt_reshape = seed_gt_votes.reshape(b * num_seed, GT_VOTE_FACTOR, 3)
    _, _, dist2, _ = nn_distance(vote_reshape, gt_reshape, l1=True)
    votes_dist = torch.amin(dist2, dim=1).reshape(b, num_seed)
    return masked_mean(votes_dist, seed_gt_votes_mask)


def compute_objectness_loss(end_points):
    """`loss_helper.py:111-152`. Returns (loss, label, mask, assignment)."""
    gt_center = end_points["center_label"][:, :, 0:3]
    dist1, ind1, _, _ = nn_distance(end_points["aggregated_vote_xyz"],
                                    gt_center)
    euclidean_dist1 = torch.sqrt(dist1 + 1e-6)
    near = euclidean_dist1 < NEAR_THRESHOLD
    objectness_label = near.to(torch.int32)
    objectness_mask = (near | (euclidean_dist1 > FAR_THRESHOLD)).to(
        torch.float32)

    loss = softmax_ce(end_points["objectness_scores"], objectness_label,
                      OBJECTNESS_CLS_WEIGHTS)
    loss = masked_mean(loss, objectness_mask)
    return loss, objectness_label, objectness_mask, ind1


def compute_box_and_sem_cls_loss(end_points, config):
    """`loss_helper.py:154-228`: centre chamfer both ways + heading
    cls/reg + size cls/reg + sem cls, objectness-masked."""
    nh = config.num_heading_bin
    ns = config.num_size_cluster
    # non_blocking: a host constant needs no stream sync
    mean_size_arr = torch.as_tensor(config.mean_size_arr,
                                    dtype=torch.float32).to(
        end_points["center"].device, non_blocking=True)

    assignment = end_points["object_assignment"]
    objectness_label = end_points["objectness_label"].to(torch.float32)

    gt_center = end_points["center_label"][:, :, 0:3]
    dist1, _, dist2, _ = nn_distance(end_points["center"], gt_center)
    center_loss = (masked_mean(dist1, objectness_label)
                   + masked_mean(dist2, end_points["box_label_mask"]))

    heading_class_label = _take(end_points["heading_class_label"],
                                assignment)
    heading_class_loss = masked_mean(
        softmax_ce(end_points["heading_scores"], heading_class_label),
        objectness_label)

    heading_residual_label = _take(end_points["heading_residual_label"],
                                   assignment)
    heading_residual_normalized_label = (
        heading_residual_label / (math.pi / nh))
    heading_one_hot = one_hot_f32(heading_class_label, nh)
    heading_residual_normalized_loss = huber_loss(
        torch.sum(end_points["heading_residuals_normalized"]
                  * heading_one_hot, -1)
        - heading_residual_normalized_label, delta=1.0)
    heading_residual_normalized_loss = masked_mean(
        heading_residual_normalized_loss, objectness_label)

    size_class_label = _take(end_points["size_class_label"], assignment)
    size_class_loss = masked_mean(
        softmax_ce(end_points["size_scores"], size_class_label),
        objectness_label)

    size_residual_label = _take(end_points["size_residual_label"],
                                assignment)  # (B,K,3)
    size_one_hot = one_hot_f32(size_class_label, ns)[..., None]  # (B,K,NS,1)
    pred_size_residual_normalized = torch.sum(
        end_points["size_residuals_normalized"] * size_one_hot, dim=2)
    mean_size_label = torch.sum(size_one_hot * mean_size_arr[None, None],
                                dim=2)
    size_residual_label_normalized = size_residual_label / mean_size_label
    size_residual_normalized_loss = torch.mean(
        huber_loss(pred_size_residual_normalized
                   - size_residual_label_normalized, delta=1.0), dim=-1)
    size_residual_normalized_loss = masked_mean(
        size_residual_normalized_loss, objectness_label)

    sem_cls_label = _take(end_points["sem_cls_label"], assignment)
    sem_cls_loss = masked_mean(
        softmax_ce(end_points["sem_cls_scores"], sem_cls_label),
        objectness_label)

    return (center_loss, heading_class_loss,
            heading_residual_normalized_loss, size_class_loss,
            size_residual_normalized_loss, sem_cls_loss)


def _objectness_stats(end_points, objectness_label, objectness_mask):
    total = objectness_label.shape[0] * objectness_label.shape[1]
    pos_ratio = torch.sum(objectness_label.to(torch.float32)) / total
    neg_ratio = (torch.sum(objectness_mask.to(torch.float32)) / total
                 - pos_ratio)
    obj_pred = torch.argmax(end_points["objectness_scores"], 2)
    obj_acc = masked_mean((obj_pred == objectness_label).to(torch.float32),
                          objectness_mask)
    return pos_ratio, neg_ratio, obj_acc


def get_loss(end_points, config):
    """FSB criterion (`loss_helper.py:336-400`). Returns (loss, aux)."""
    aux = {}
    vote_loss = compute_vote_loss(end_points)
    aux["vote_loss"] = vote_loss

    (objectness_loss, objectness_label, objectness_mask,
     object_assignment) = compute_objectness_loss(end_points)
    aux["objectness_loss"] = objectness_loss
    aux["objectness_label"] = objectness_label
    aux["objectness_mask"] = objectness_mask
    aux["object_assignment"] = object_assignment
    end_points = dict(end_points, objectness_label=objectness_label,
                      object_assignment=object_assignment)

    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss,
     size_reg_loss, sem_cls_loss) = compute_box_and_sem_cls_loss(
         end_points, config)
    box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss
                + 0.1 * size_cls_loss + size_reg_loss)
    aux.update(center_loss=center_loss, heading_cls_loss=heading_cls_loss,
               heading_reg_loss=heading_reg_loss,
               size_cls_loss=size_cls_loss, size_reg_loss=size_reg_loss,
               sem_cls_loss=sem_cls_loss, box_loss=box_loss)

    loss = (vote_loss + 0.5 * objectness_loss + box_loss
            + 0.1 * sem_cls_loss) * 10.0
    aux["loss"] = loss

    pos_ratio, neg_ratio, obj_acc = _objectness_stats(
        end_points, objectness_label, objectness_mask)
    aux.update(pos_ratio=pos_ratio, neg_ratio=neg_ratio, obj_acc=obj_acc)
    return loss, aux
