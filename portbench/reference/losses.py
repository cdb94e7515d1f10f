"""The detectors' fully supervised criteria, plain: VoteNet's
(`loss_helper.py` of facebookresearch/votenet: vote, objectness, box and
semantic terms, weighted and scaled by 10) and GroupFree3D's (KPS focal
loss on each box's top-k seeds, and per head a sigmoid focal objectness,
smooth-L1 centre, heading and size regressions and the class terms,
averaged over the heads and scaled by 10)."""

from __future__ import annotations

import math

import torch

from portbench.reference.ops import (huber_loss, nn_distance,
                                     top_k_indices)


def take_rows(x, index):
    index = index.long()
    if x.dim() > 2:
        index = index.reshape(index.shape + (1,) * (x.dim() - 2)).expand(
            -1, -1, *x.shape[2:])
    return torch.gather(x, 1, index)


def masked_mean(x, mask, eps: float = 1e-6):
    mask = mask.to(torch.float32)
    return torch.sum(x * mask) / (torch.sum(mask) + eps)


def softmax_ce(logits, labels, class_weights=None):
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=torch.float32).to(
            logits.device)[labels]
        nll = nll * w
    return nll


def one_hot_f32(labels, num: int):
    labels = labels.long()
    return (labels[..., None] == torch.arange(num, device=labels.device)).to(
        torch.float32)


# ---------------------------------------------------------------------------
# VoteNet
# ---------------------------------------------------------------------------


def votenet_loss(ep, mean_size_arr, nh: int, ns: int):
    """(loss, aux) of the FSB criterion; `ep` holds the model's outputs
    and the labels."""
    b, num_seed, _ = ep["seed_xyz"].shape
    seed_inds = ep["seed_inds"]
    mask = take_rows(ep["vote_label_mask"], seed_inds)
    gt_votes = take_rows(ep["vote_label"], seed_inds) + ep["seed_xyz"].repeat(
        1, 1, 3)
    _, _, dist2, _ = nn_distance(ep["vote_xyz"].reshape(b * num_seed, -1, 3),
                                 gt_votes.reshape(b * num_seed, 3, 3), l1=True)
    vote_loss = masked_mean(torch.amin(dist2, dim=1).reshape(b, num_seed),
                            mask)

    gt_center = ep["center_label"][:, :, 0:3]
    dist1, assignment, _, _ = nn_distance(ep["aggregated_vote_xyz"],
                                          gt_center)
    euclid = torch.sqrt(dist1 + 1e-6)
    near = euclid < 0.3
    objectness_label = near.to(torch.int32)
    objectness_mask = (near | (euclid > 0.6)).to(torch.float32)
    objectness_loss = masked_mean(
        softmax_ce(ep["objectness_scores"], objectness_label, (0.2, 0.8)),
        objectness_mask)

    msa = torch.as_tensor(mean_size_arr, dtype=torch.float32).to(
        gt_center.device)
    obj = objectness_label.to(torch.float32)
    dist1, _, dist2, _ = nn_distance(ep["center"], gt_center)
    center_loss = (masked_mean(dist1, obj)
                   + masked_mean(dist2, ep["box_label_mask"]))
    hcl = take_rows(ep["heading_class_label"], assignment)
    heading_cls_loss = masked_mean(softmax_ce(ep["heading_scores"], hcl), obj)
    hrl = take_rows(ep["heading_residual_label"], assignment) / (math.pi / nh)
    heading_reg_loss = masked_mean(huber_loss(
        torch.sum(ep["heading_residuals_normalized"] * one_hot_f32(hcl, nh),
                  -1) - hrl, delta=1.0), obj)
    scl = take_rows(ep["size_class_label"], assignment)
    size_cls_loss = masked_mean(softmax_ce(ep["size_scores"], scl), obj)
    srl = take_rows(ep["size_residual_label"], assignment)
    s_one_hot = one_hot_f32(scl, ns)[..., None]
    pred_srn = torch.sum(ep["size_residuals_normalized"] * s_one_hot, dim=2)
    mean_size_label = torch.sum(s_one_hot * msa[None, None], dim=2)
    size_reg_loss = masked_mean(torch.mean(huber_loss(
        pred_srn - srl / mean_size_label, delta=1.0), dim=-1), obj)
    sem_cls_loss = masked_mean(
        softmax_ce(ep["sem_cls_scores"], take_rows(ep["sem_cls_label"],
                                                   assignment)), obj)
    box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss
                + 0.1 * size_cls_loss + size_reg_loss)
    loss = (vote_loss + 0.5 * objectness_loss + box_loss
            + 0.1 * sem_cls_loss) * 10.0
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# GroupFree3D
# ---------------------------------------------------------------------------


def smoothl1(error, delta: float = 1.0):
    diff = torch.abs(error)
    return torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)


def sigmoid_focal(logits, targets, weights, gamma=2.0, alpha=0.25):
    p = torch.sigmoid(logits)
    alpha_weight = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - p) + (1.0 - targets) * p
    bce = (torch.clamp(logits, min=0.0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return alpha_weight * torch.pow(pt, gamma) * bce * weights[..., None]


def _normalized_weights(mask):
    w = mask.to(torch.float32)
    return w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)


def _kps_loss(ep, topk):
    seed_xyz = ep["seed_xyz"]
    gt_center = ep["center_label"][:, :, 0:3]
    gt_size = ep["size_gts"][:, :, 0:3]
    k2 = gt_center.shape[1]
    assignment = take_rows(ep["point_instance_label"], ep["seed_inds"])
    background = assignment < 0
    assignment = torch.where(background, k2 - 1, assignment)
    one_hot = one_hot_f32(assignment, k2)
    delta = ((seed_xyz[:, :, None, :] - gt_center[:, None, :, :])
             / (gt_size[:, None, :, :] + 1e-6))
    dist = torch.sqrt(torch.sum(torch.square(delta), -1) + 1e-6)
    dist = (dist * one_hot + 100.0 * (1 - one_hot)).transpose(1, 2)
    b, _, k = dist.shape
    valid = ep["box_label_mask"][:, :, None] > 0
    scatter = torch.where(valid, top_k_indices(-dist, topk), k).reshape(b, -1)
    label = torch.zeros((b, k + 1), dtype=torch.int32, device=dist.device)
    label.scatter_(1, scatter, 1)
    label = torch.where(background, 0, label[:, :k])
    weights = _normalized_weights(torch.ones((b, k), device=dist.device))
    loss = sigmoid_focal(ep["seeds_obj_cls_logits"],
                         label[..., None].to(torch.float32), weights)
    return torch.sum(loss) / b


def groupfree_loss(ep, mean_size_arr, nh: int, ns: int, num_decoder_layers,
                   query_points_generator_loss_coef, obj_loss_coef,
                   box_loss_coef, sem_cls_loss_coef, query_points_obj_topk,
                   center_delta, size_delta, heading_delta):
    """(loss, aux) of the FSB criterion with smooth-L1 regressions."""
    kps = _kps_loss(ep, query_points_obj_topk)
    q_inds = ep["query_points_sample_inds"]
    k2 = ep["center_label"].shape[1]
    obj_gt = take_rows(take_rows(ep["point_obj_mask"], ep["seed_inds"]),
                       q_inds).to(torch.int32)
    instance = take_rows(take_rows(ep["point_instance_label"],
                                   ep["seed_inds"]), q_inds)
    assignment = torch.where(instance < 0, k2 - 1, instance).to(torch.int32)
    b, k = obj_gt.shape
    weights = _normalized_weights(torch.ones((b, k), device=obj_gt.device))
    obj = obj_gt.to(torch.float32)
    gt_center = ep["center_label"][:, :, 0:3]
    msa = torch.as_tensor(mean_size_arr, dtype=torch.float32).to(
        gt_center.device)
    prefixes = (["proposal_", "last_"]
                + [f"{i}head_" for i in range(num_decoder_layers - 1)])
    obj_sum = box_sum = sem_sum = 0.0
    for p in prefixes:
        obj_sum = obj_sum + torch.sum(sigmoid_focal(
            ep[f"{p}objectness_scores"], obj[..., None], weights)) / b
        closs = smoothl1(take_rows(gt_center, assignment) - ep[f"{p}center"],
                         delta=center_delta)
        center_loss = (torch.sum(closs * obj[..., None])
                       / (torch.sum(obj) + 1e-6))
        hcl = take_rows(ep["heading_class_label"], assignment)
        heading_cls = masked_mean(softmax_ce(ep[f"{p}heading_scores"], hcl),
                                  obj)
        herr = torch.sum(ep[f"{p}heading_residuals_normalized"]
                         * one_hot_f32(hcl, nh), -1) - take_rows(
            ep["heading_residual_label"], assignment) / (math.pi / nh)
        heading_reg = masked_mean(
            heading_delta * smoothl1(herr, delta=heading_delta), obj)
        scl = take_rows(ep["size_class_label"], assignment)
        size_cls = masked_mean(softmax_ce(ep[f"{p}size_scores"], scl), obj)
        s_one_hot = one_hot_f32(scl, ns)
        pred_srn = torch.sum(ep[f"{p}size_residuals_normalized"]
                             * s_one_hot[..., None], dim=2)
        mean_size_label = torch.sum(s_one_hot[..., None] * msa[None, None],
                                    dim=2)
        serr = pred_srn - take_rows(ep["size_residual_label"],
                                    assignment) / mean_size_label
        sloss = size_delta * smoothl1(serr, delta=size_delta)
        size_reg = torch.sum(sloss * obj[..., None]) / (torch.sum(obj) + 1e-6)
        sem = masked_mean(softmax_ce(
            ep[f"{p}sem_cls_scores"],
            take_rows(ep["sem_cls_label"], assignment)), obj)
        box_sum = box_sum + (center_loss + 0.1 * heading_cls + heading_reg
                             + 0.1 * size_cls + size_reg)
        sem_sum = sem_sum + sem
    loss = (query_points_generator_loss_coef * kps
            + 1.0 / (num_decoder_layers + 1)
            * (obj_loss_coef * obj_sum + box_loss_coef * box_sum
               + sem_cls_loss_coef * sem_sum)) * 10.0
    return loss, {"loss": loss}
