"""GroupFree3D training criteria: FSB, WSB, BR, BR+CenterRefine and the
pseudo-label suite.

Counterpart of ``backtoreality_tpu/losses/groupfree.py`` (reference
`detection/GroupFree3D/models/loss_helper.py`: KPS :17-78, per-head
objectness :81-137, per-head box :140-275, get_loss :278-315, weak
variants :322-608, DA and jitter :673-771, pseudo labels :777-1146;
`models/losses.py:5-81`). Every function takes end_points (model outputs
merged with the labels, channels-last) and the criteria return
``(loss, aux)``; nothing is mutated. Per-head prefixes are
``proposal_``, ``0head_`` ... ``{L-2}head_`` and ``last_``.

`get_loss_weak` keeps only the weak terms: the reference weights its
full-label terms by 0.000, so they add nothing to value or gradient.

The hard top-k selections pick, among equal distances, the lower seed
index first, as XLA's top-k does: a box with fewer seeds than `topk`
inside its instance ties at 100.0 for the rest.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from backtoreality_tpu_torch.eval.ap_helper import (_vectorized_class2angle,
                                                    softmax)
from backtoreality_tpu_torch.eval.box3d import (flip_axis_to_camera,
                                                get_3d_box_batch)
from backtoreality_tpu_torch.eval.nms import nms_3d_faster_samecls
from backtoreality_tpu_torch.losses.common import (compute_jitter_loss,
                                                   masked_mean, one_hot_f32,
                                                   refine_center_labels,
                                                   sigmoid_bce_with_logits,
                                                   softmax_ce,
                                                   softmax_focal_loss,
                                                   take_rows)
from backtoreality_tpu_torch.ops import nn_distance, top_k_indices
from backtoreality_tpu_torch.train.observability import spanned


def smoothl1_loss(error, delta: float = 1.0):
    """`losses.py:5-14`: 0.5 x^2/d inside, |x| - d/2 outside."""
    diff = torch.abs(error)
    return torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)


def sigmoid_focal_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """`SigmoidFocalClassificationLoss` (`losses.py:21-81`), tf-style.
    logits/targets (..., C); weights broadcast over the class dim."""
    p = torch.sigmoid(logits)
    alpha_weight = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - p) + (1.0 - targets) * p
    focal_weight = alpha_weight * torch.pow(pt, gamma)
    bce = sigmoid_bce_with_logits(logits, targets)
    return focal_weight * bce * weights[..., None]


def _prefixes(num_decoder_layers):
    if num_decoder_layers > 0:
        return (["proposal_", "last_"]
                + [f"{i}head_" for i in range(num_decoder_layers - 1)])
    return ["proposal_"]


def _normalized_weights(mask):
    """Per-scan weight normalisation used by every GF focal term."""
    w = mask.to(torch.float32)
    norm = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
    return w / norm


def _mean_size_arr(config, device):
    # non_blocking: a host constant needs no stream sync
    return torch.as_tensor(config.mean_size_arr, dtype=torch.float32).to(
        device, non_blocking=True)


# ---------------------------------------------------------------------------
# KPS (query point) supervision
# ---------------------------------------------------------------------------


def _topk_labels(dist, box_label_mask, topk):
    """Seeds among each valid box's `topk` nearest (dist (B, K2, K)) are
    labelled 1: (B, K) int32."""
    b, _, k = dist.shape
    topk_inds = top_k_indices(-dist, topk)  # (B, K2, topk)
    valid = box_label_mask[:, :, None] > 0
    # masked-out boxes write into a dummy K-th column
    scatter_idx = torch.where(valid, topk_inds, k).reshape(b, -1)
    label = torch.zeros((b, k + 1), dtype=torch.int32, device=dist.device)
    label.scatter_(1, scatter_idx, 1)
    return label[:, :k]


def _kps_loss(logits, objectness_label, topk):
    b, k = objectness_label.shape
    weights = _normalized_weights(torch.ones((b, k), device=logits.device))
    loss = sigmoid_focal_loss(
        logits, objectness_label[..., None].to(torch.float32), weights)
    pos_ratio = torch.sum(objectness_label.to(torch.float32)) / (b * k)
    stats = {
        f"points_hard_topk{topk}_pos_ratio": pos_ratio,
        f"points_hard_topk{topk}_neg_ratio": 1.0 - pos_ratio,
    }
    return torch.sum(loss) / b, stats


@spanned("loss.kps")
def compute_points_obj_cls_loss_hard_topk(end_points, topk):
    """`loss_helper.py:17-78`: for each GT box, its top-k
    size-normalized-closest seeds *within the instance* are positives."""
    seed_inds = end_points["seed_inds"]
    seed_xyz = end_points["seed_xyz"]
    gt_center = end_points["center_label"][:, :, 0:3]
    gt_size = end_points["size_gts"][:, :, 0:3]
    k2 = gt_center.shape[1]

    assignment = take_rows(end_points["point_instance_label"], seed_inds)
    background = assignment < 0
    assignment = torch.where(background, k2 - 1, assignment)
    assign_one_hot = one_hot_f32(assignment, k2)  # (B, K, K2)
    delta_xyz = ((seed_xyz[:, :, None, :] - gt_center[:, None, :, :])
                 / (gt_size[:, None, :, :] + 1e-6))
    dist = torch.sqrt(torch.sum(torch.square(delta_xyz), -1) + 1e-6)
    dist = dist * assign_one_hot + 100.0 * (1 - assign_one_hot)
    label = _topk_labels(dist.transpose(1, 2), end_points["box_label_mask"],
                         topk)
    label = torch.where(background, 0, label)
    return _kps_loss(end_points["seeds_obj_cls_logits"], label, topk)


@spanned("loss.kps")
def compute_points_obj_cls_loss_hard_topk_weak(end_points, topk):
    """`loss_helper.py:322-385`: weak variant — top-k on the raw distance
    to the weak centres, no instance masking."""
    seed_xyz = end_points["seed_xyz"]
    gt_center = end_points["center_label"][:, :, 0:3]
    delta_xyz = seed_xyz[:, :, None, :] - gt_center[:, None, :, :]
    dist = torch.sqrt(torch.sum(torch.square(delta_xyz), -1) + 1e-6)
    label = _topk_labels(dist.transpose(1, 2), end_points["box_label_mask"],
                         topk)
    return _kps_loss(end_points["seeds_obj_cls_logits"], label, topk)


# ---------------------------------------------------------------------------
# Per-head objectness
# ---------------------------------------------------------------------------


def _query_labels_full(end_points):
    """Instance-based objectness labels/assignment (`loss_helper.py:97-117`)."""
    seed_inds = end_points["seed_inds"]
    q_inds = end_points["query_points_sample_inds"]
    k2 = end_points["center_label"].shape[1]
    seed_obj_gt = take_rows(end_points["point_obj_mask"], seed_inds)
    query_obj_gt = take_rows(seed_obj_gt, q_inds)
    seed_instance = take_rows(end_points["point_instance_label"], seed_inds)
    query_instance = take_rows(seed_instance, q_inds)
    assignment = torch.where(query_instance < 0, k2 - 1, query_instance)
    return query_obj_gt.to(torch.int32), assignment.to(torch.int32)


def _query_labels_weak(end_points):
    """Chamfer-based weak labels (`loss_helper.py:416-455`)."""
    gt_center = end_points["center_label"][:, :, 0:3]
    dist1, ind1, _, _ = nn_distance(end_points["query_points_xyz"],
                                    gt_center)
    euclid = torch.sqrt(dist1 + 1e-6)
    return (euclid < 0.3).to(torch.int32), ind1.to(torch.int32)


@spanned("loss.objectness")
def compute_objectness_loss_query_points(end_points, num_decoder_layers,
                                         weak=False):
    """Per-prefix sigmoid-focal objectness. Returns
    (loss_sum, {prefix: (label, assignment)}, aux)."""
    labels, aux = {}, {}
    loss_sum = 0.0
    label, assignment = (_query_labels_weak(end_points) if weak
                         else _query_labels_full(end_points))
    b, k = label.shape
    weights = _normalized_weights(torch.ones((b, k), device=label.device))
    for prefix in _prefixes(num_decoder_layers):
        scores = end_points[f"{prefix}objectness_scores"]  # (B, K, 1)
        loss = sigmoid_focal_loss(
            scores, label[..., None].to(torch.float32), weights)
        objectness_loss = torch.sum(loss) / b
        aux[f"{prefix}objectness_loss"] = objectness_loss
        labels[prefix] = (label, assignment)
        loss_sum = loss_sum + objectness_loss
    aux["pos_ratio"] = torch.sum(label.to(torch.float32)) / (b * k)
    aux["neg_ratio"] = 1.0 - aux["pos_ratio"]
    return loss_sum, labels, aux


# ---------------------------------------------------------------------------
# Per-head box + semantic losses
# ---------------------------------------------------------------------------


def _center_loss(end_points, prefix, assigned_center, center_loss_type,
                 center_delta):
    error = assigned_center - end_points[f"{prefix}center"]
    if center_loss_type == "smoothl1":
        return smoothl1_loss(error, delta=center_delta)
    return torch.abs(error)


def _label_sum_mean(loss, objectness_label):
    """sum(loss * label) / (sum(label) + 1e-6) over (B, K, 3) terms."""
    return (torch.sum(loss * objectness_label[..., None])
            / (torch.sum(objectness_label) + 1e-6))


@spanned("loss.box_sem")
def compute_box_and_sem_cls_loss(end_points, config, num_decoder_layers,
                                 labels, center_loss_type="smoothl1",
                                 center_delta=1.0,
                                 size_loss_type="smoothl1", size_delta=1.0,
                                 heading_loss_type="smoothl1",
                                 heading_delta=1.0, label_key_prefix=""):
    """`loss_helper.py:140-275`: regression to the assigned GT box, per
    head. `label_key_prefix` picks the labels: "" the dataset's,
    "unlabeled_" the pseudo labels (`loss_helper.py:960-1080`)."""
    lp = label_key_prefix
    nh, ns = config.num_heading_bin, config.num_size_cluster
    gt_center = end_points[f"{lp}center_label"][:, :, 0:3]
    mean_size_arr = _mean_size_arr(config, gt_center.device)

    box_loss_sum = sem_cls_loss_sum = 0.0
    aux = {}
    for prefix in _prefixes(num_decoder_layers):
        label, assignment = labels[prefix]
        objectness_label = label.to(torch.float32)

        closs = _center_loss(end_points, prefix,
                             take_rows(gt_center, assignment),
                             center_loss_type, center_delta)
        center_loss = _label_sum_mean(closs, objectness_label)

        heading_class_label = take_rows(
            end_points[f"{lp}heading_class_label"], assignment)
        heading_class_loss = masked_mean(
            softmax_ce(end_points[f"{prefix}heading_scores"],
                       heading_class_label), objectness_label)
        heading_residual_label = take_rows(
            end_points[f"{lp}heading_residual_label"], assignment)
        hrnl = heading_residual_label / (math.pi / nh)
        h_one_hot = one_hot_f32(heading_class_label, nh)
        herr = torch.sum(
            end_points[f"{prefix}heading_residuals_normalized"] * h_one_hot,
            -1) - hrnl
        if heading_loss_type == "smoothl1":
            hloss = heading_delta * smoothl1_loss(herr, delta=heading_delta)
        else:
            hloss = torch.abs(herr)
        heading_reg_loss = masked_mean(hloss, objectness_label)

        size_class_label = take_rows(end_points[f"{lp}size_class_label"],
                                     assignment)
        size_class_loss = masked_mean(
            softmax_ce(end_points[f"{prefix}size_scores"], size_class_label),
            objectness_label)
        size_residual_label = take_rows(
            end_points[f"{lp}size_residual_label"], assignment)
        s_one_hot = one_hot_f32(size_class_label, ns)
        pred_srn = torch.sum(
            end_points[f"{prefix}size_residuals_normalized"]
            * s_one_hot[..., None], dim=2)
        mean_size_label = torch.sum(
            s_one_hot[..., None] * mean_size_arr[None, None], dim=2)
        serr = pred_srn - size_residual_label / mean_size_label
        if size_loss_type == "smoothl1":
            sloss = size_delta * smoothl1_loss(serr, delta=size_delta)
        else:
            sloss = torch.abs(serr)
        size_reg_loss = _label_sum_mean(sloss, objectness_label)

        sem_cls_label = take_rows(end_points[f"{lp}sem_cls_label"],
                                  assignment)
        sem_cls_loss = masked_mean(
            softmax_ce(end_points[f"{prefix}sem_cls_scores"], sem_cls_label),
            objectness_label)

        box_loss = (center_loss + 0.1 * heading_class_loss
                    + heading_reg_loss + 0.1 * size_class_loss
                    + size_reg_loss)
        aux[f"{prefix}box_loss"] = box_loss
        aux[f"{prefix}center_loss"] = center_loss
        aux[f"{prefix}sem_cls_loss"] = sem_cls_loss
        box_loss_sum = box_loss_sum + box_loss
        sem_cls_loss_sum = sem_cls_loss_sum + sem_cls_loss
    return box_loss_sum, sem_cls_loss_sum, aux


@spanned("loss.box_sem")
def compute_center_and_sem_cls_loss(end_points, config, num_decoder_layers,
                                    labels, center_loss_type="smoothl1",
                                    center_delta=1.0):
    """`loss_helper.py:479-557`: weak variant — margin-relaxed centre,
    size class and semantic class."""
    gt_center = end_points["center_label"][:, :, 0:3]
    mean_size_arr = _mean_size_arr(config, gt_center.device)

    box_loss_sum = sem_cls_loss_sum = 0.0
    aux = {}
    for prefix in _prefixes(num_decoder_layers):
        label, assignment = labels[prefix]
        objectness_label = label.to(torch.float32)

        size_class_label = take_rows(end_points["size_class_label"],
                                     assignment).long()
        center_margin = 0.05 * mean_size_arr[size_class_label]  # (B,K,3)
        closs = _center_loss(end_points, prefix,
                             take_rows(gt_center, assignment),
                             center_loss_type, center_delta)
        closs = torch.clamp(closs - center_margin, min=0.0)
        center_loss = _label_sum_mean(closs, objectness_label)

        size_class_loss = masked_mean(
            softmax_ce(end_points[f"{prefix}size_scores"], size_class_label),
            objectness_label)
        sem_cls_label = take_rows(end_points["sem_cls_label"], assignment)
        sem_cls_loss = masked_mean(
            softmax_ce(end_points[f"{prefix}sem_cls_scores"], sem_cls_label),
            objectness_label)

        box_loss = center_loss + 0.1 * size_class_loss
        aux[f"{prefix}box_loss"] = box_loss
        aux[f"{prefix}center_loss"] = center_loss
        aux[f"{prefix}sem_cls_loss"] = sem_cls_loss
        box_loss_sum = box_loss_sum + box_loss
        sem_cls_loss_sum = sem_cls_loss_sum + sem_cls_loss
    return box_loss_sum, sem_cls_loss_sum, aux


# ---------------------------------------------------------------------------
# Compositions
# ---------------------------------------------------------------------------


def _compose(aux, kps_loss, obj_loss_sum, box_loss_sum, sem_cls_loss_sum,
             num_decoder_layers, query_points_generator_loss_coef,
             obj_loss_coef, box_loss_coef, sem_cls_loss_coef):
    aux["sum_heads_objectness_loss"] = obj_loss_sum
    aux["sum_heads_box_loss"] = box_loss_sum
    aux["sum_heads_sem_cls_loss"] = sem_cls_loss_sum
    loss = (query_points_generator_loss_coef * kps_loss
            + 1.0 / (num_decoder_layers + 1)
            * (obj_loss_coef * obj_loss_sum
               + box_loss_coef * box_loss_sum
               + sem_cls_loss_coef * sem_cls_loss_sum)) * 10.0
    aux["loss"] = loss
    return loss


@spanned("loss")
def get_loss(end_points, config, num_decoder_layers,
             query_points_generator_loss_coef, obj_loss_coef,
             box_loss_coef, sem_cls_loss_coef, query_points_obj_topk=5,
             **reg_kwargs):
    """FSB criterion (`loss_helper.py:278-315`)."""
    aux = {}
    kps_loss = 0.0
    if "seeds_obj_cls_logits" in end_points:
        kps_loss, stats = compute_points_obj_cls_loss_hard_topk(
            end_points, query_points_obj_topk)
        aux.update(stats)
        aux["query_points_generation_loss"] = kps_loss
    obj_loss_sum, labels, obj_aux = compute_objectness_loss_query_points(
        end_points, num_decoder_layers, weak=False)
    aux.update(obj_aux)
    box_loss_sum, sem_cls_loss_sum, box_aux = compute_box_and_sem_cls_loss(
        end_points, config, num_decoder_layers, labels, **reg_kwargs)
    aux.update(box_aux)
    loss = _compose(aux, kps_loss, obj_loss_sum, box_loss_sum,
                    sem_cls_loss_sum, num_decoder_layers,
                    query_points_generator_loss_coef, obj_loss_coef,
                    box_loss_coef, sem_cls_loss_coef)
    return loss, aux


@spanned("loss")
def get_loss_weak(end_points, config, num_decoder_layers,
                  query_points_generator_loss_coef, obj_loss_coef,
                  box_loss_coef, sem_cls_loss_coef,
                  query_points_obj_topk=5, **reg_kwargs):
    """WSB criterion (`loss_helper.py:561-608`; the 0.000-weighted full
    terms are omitted). aux also holds ``_last_objectness_label``, the
    last head's labels (B, K), for the DA criterion."""
    aux = {}
    kps_loss = 0.0
    if "seeds_obj_cls_logits" in end_points:
        kps_loss, stats = compute_points_obj_cls_loss_hard_topk_weak(
            end_points, query_points_obj_topk)
        aux.update(stats)
        aux["query_points_generation_loss"] = kps_loss
    obj_loss_sum, labels, obj_aux = compute_objectness_loss_query_points(
        end_points, num_decoder_layers, weak=True)
    aux.update(obj_aux)
    center_kwargs = {k: v for k, v in reg_kwargs.items()
                     if k in ("center_loss_type", "center_delta")}
    box_loss_sum, sem_cls_loss_sum, box_aux = (
        compute_center_and_sem_cls_loss(end_points, config,
                                        num_decoder_layers, labels,
                                        **center_kwargs))
    aux.update(box_aux)
    loss = _compose(aux, kps_loss, obj_loss_sum, box_loss_sum,
                    sem_cls_loss_sum, num_decoder_layers,
                    query_points_generator_loss_coef, obj_loss_coef,
                    box_loss_coef, sem_cls_loss_coef)
    aux["_last_objectness_label"] = labels.get(
        "last_", labels["proposal_"])[0]
    return loss, aux


# ---------------------------------------------------------------------------
# Domain adaptation (BR) and centre refinement (BR+CenterRefine)
# ---------------------------------------------------------------------------


def _gf_da_terms(end_points_S, end_points_T, label_S, label_T):
    """`loss_helper.py:685-709`: the global softmax focal term (gamma 3)
    of each domain plus the last layer's local L2 term, weighted by the
    objectness labels."""
    global_S = end_points_S["global_d_pred"]
    global_T = end_points_T["global_d_pred"]
    domain_S = torch.zeros(global_S.shape[0], dtype=torch.int64,
                           device=global_S.device)
    domain_T = torch.ones(global_T.shape[0], dtype=torch.int64,
                          device=global_T.device)
    local_S = end_points_S["last_local_d_pred"][..., 0]
    local_T = end_points_T["last_local_d_pred"][..., 0]
    source = (softmax_focal_loss(global_S, domain_S, gamma=3)
              + torch.mean(torch.square(local_S) * label_S.to(torch.float32)))
    target = (softmax_focal_loss(global_T, domain_T, gamma=3)
              + torch.mean(torch.square(1.0 - local_T)
                           * label_T.to(torch.float32)))
    return source + target


def _da_losses(end_points_S, end_points_T, config, num_decoder_layers,
               query_points_generator_loss_coef, obj_loss_coef,
               box_loss_coef, sem_cls_loss_coef, query_points_obj_topk,
               reg_kwargs):
    """0.5 * full(S) + weak(T), the DA term and the aux of both domains;
    returns (supervised loss, DA term, aux)."""
    coefs = (num_decoder_layers, query_points_generator_loss_coef,
             obj_loss_coef, box_loss_coef, sem_cls_loss_coef,
             query_points_obj_topk)
    loss_S, aux_S = get_loss(end_points_S, config, *coefs, **reg_kwargs)
    loss_T, aux_T = get_loss_weak(end_points_T, config, *coefs,
                                  **reg_kwargs)
    # the source's last-head labels: the full rule's, shared by every head
    label_S = _query_labels_full(end_points_S)[0]
    label_T = aux_T.pop("_last_objectness_label")
    da_loss = _gf_da_terms(end_points_S, end_points_T, label_S, label_T)
    aux = {"loss_S": loss_S, "loss_T": loss_T}
    aux.update({f"S_{k}": v for k, v in aux_S.items()})
    aux.update({f"T_{k}": v for k, v in aux_T.items()})
    return 0.5 * loss_S + loss_T, da_loss, aux


@spanned("loss")
def get_loss_DA(end_points_S, end_points_T, config, num_decoder_layers,
                query_points_generator_loss_coef, obj_loss_coef,
                box_loss_coef, sem_cls_loss_coef, query_points_obj_topk=5,
                **reg_kwargs):
    """BR criterion (`loss_helper.py:673-712`):
    0.5 * full(S) + weak(T) + 10 * (global focal + last-layer local)."""
    supervised, da_loss, aux = _da_losses(
        end_points_S, end_points_T, config, num_decoder_layers,
        query_points_generator_loss_coef, obj_loss_coef, box_loss_coef,
        sem_cls_loss_coef, query_points_obj_topk, reg_kwargs)
    loss = supervised + 10.0 * da_loss
    return loss, {"loss": loss, "da_loss": da_loss, **aux}


@spanned("loss")
def get_loss_DA_jitter(end_points_S, end_points_T, epoch, config,
                       num_decoder_layers, query_points_generator_loss_coef,
                       obj_loss_coef, box_loss_coef, sem_cls_loss_coef,
                       query_points_obj_topk=5, **reg_kwargs):
    """BR+CenterRefine criterion (`loss_helper.py:723-771`): the labels
    refined first; the DA term also holds 0.5 * the source's jitter loss.
    `epoch` is a host number."""
    end_points_S, end_points_T = refine_center_labels(
        end_points_S, end_points_T, epoch, ramp_epochs=120)
    jitter_loss_S = compute_jitter_loss(end_points_S)
    supervised, da_loss, aux = _da_losses(
        end_points_S, end_points_T, config, num_decoder_layers,
        query_points_generator_loss_coef, obj_loss_coef, box_loss_coef,
        sem_cls_loss_coef, query_points_obj_topk, reg_kwargs)
    da_loss = da_loss + 0.5 * jitter_loss_S
    loss = supervised + 10.0 * da_loss
    return loss, {"loss": loss, "da_loss": da_loss,
                  "jitter_loss_S": jitter_loss_S, **aux}


# ---------------------------------------------------------------------------
# Self-training / pseudo-label suite (`loss_helper.py:777-1146`)
#
# On no recipe's path. The JAX package rebuilt it as a runnable capability
# (its `use_lhs` branch suppresses duplicates with the same-class 3D NMS of
# `eval/nms.py`, and `get_loss_pseudo` slices the student's tensors to the
# unlabeled rows); this is its counterpart. Label generation is host numpy,
# between the teacher's and the student's forwards; the losses are torch.
# ---------------------------------------------------------------------------


def _host(x):
    """A tensor (on any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def get_pseudo_labels(pred_center, pred_sem_cls, pred_objectness,
                      pred_heading_scores, pred_heading_residuals,
                      pred_size_scores, pred_size_residuals, config_dict,
                      max_num_obj=64):
    """Teacher predictions -> pseudo GT labels (`loss_helper.py:777-885`).

    Keeps the proposals whose sigmoid objectness passes `obj_threshold`
    and whose softmax class confidence passes `cls_threshold`, the
    `max_num_obj` highest ``pos_obj * max_cls`` first; with `use_lhs`,
    drops same-class duplicates by 3D NMS; decodes the argmax heading and
    size bins. Returns numpy arrays (label_mask, center_label,
    sem_cls_label, heading_label, heading_residual_label, size_label,
    size_residual_label) and an aux dict; centres of non-labels at -1000."""
    pred_center = _host(pred_center)
    b, k = pred_center.shape[:2]

    pos_obj = 1.0 / (1.0 + np.exp(-_host(pred_objectness)))[:, :, 0]
    objectness_mask = pos_obj > config_dict["obj_threshold"]
    sem_probs = softmax(_host(pred_sem_cls))
    max_cls = sem_probs.max(-1)
    argmax_cls = sem_probs.argmax(-1)
    cls_mask = max_cls > config_dict["cls_threshold"]

    final_mask = cls_mask & objectness_mask
    order = np.argsort(-(pos_obj * max_cls * final_mask), axis=1)
    m = min(max_num_obj, k)  # the reference assumes K >= MAX_NUM_OBJ
    inds = order[:, :m]
    final_mask_sorted = np.take_along_axis(final_mask, inds, axis=1)
    aux = {"pseudo_gt_ratio":
           float(final_mask_sorted.sum()) / final_mask_sorted.size}

    argmax_heading = _host(pred_heading_scores).argmax(-1)
    heading_residuals = np.take_along_axis(
        _host(pred_heading_residuals), argmax_heading[..., None],
        axis=2)[..., 0]
    argmax_size = _host(pred_size_scores).argmax(-1)
    size_residuals = np.take_along_axis(
        _host(pred_size_residuals), argmax_size[..., None, None],
        axis=2)[:, :, 0]

    def take(a):
        return np.take_along_axis(a, inds.reshape(inds.shape + (1,) * (
            a.ndim - 2)), axis=1)

    center_label = take(pred_center)
    heading_label = take(argmax_heading)
    heading_residual_label = take(heading_residuals)
    size_label = take(argmax_size)
    size_residual_label = take(size_residuals)
    sem_cls_label = take(argmax_cls)

    if config_dict.get("use_lhs"):
        cfg = config_dict["dataset_config"]
        heading_angle = _vectorized_class2angle(cfg, heading_label,
                                                heading_residual_label)
        box_size = cfg.mean_size_arr[size_label] + size_residual_label
        corners = get_3d_box_batch(box_size, heading_angle,
                                   flip_axis_to_camera(center_label))
        xyz_min, xyz_max = corners.min(axis=2), corners.max(axis=2)
        score = take(pos_obj)
        for i in range(b):
            boxes = np.concatenate(
                [xyz_min[i], xyz_max[i], score[i, :, None],
                 sem_cls_label[i, :, None]], axis=1)
            pick = nms_3d_faster_samecls(
                boxes, config_dict["nms_iou"],
                config_dict.get("use_old_type_nms", False))
            keep = np.zeros(m, dtype=bool)
            keep[np.asarray(pick, dtype=np.int64)] = True
            final_mask_sorted[i] &= keep  # (`:871-877`)

    label_mask = final_mask_sorted.astype(np.int64)
    center_label = np.where(label_mask[..., None].astype(bool),
                            center_label, -1000.0)
    labels = [label_mask, center_label, sem_cls_label, heading_label,
              heading_residual_label, size_label, size_residual_label]
    if m < max_num_obj:  # pad the label slots out to MAX_NUM_OBJ
        fills = (0, -1000.0, 0, 0, 0, 0, 0)
        labels = [np.concatenate(
            [a, np.full((b, max_num_obj - m) + a.shape[2:], v, a.dtype)],
            axis=1) for a, v in zip(labels, fills)]
    return (*labels, aux)


def compute_objectness_loss_query_points_pseudo(end_points,
                                                num_decoder_layers):
    """`loss_helper.py:888-957`: per-prefix objectness for the pseudo
    stage, labelled by the weak rule against the dataset's
    `center_label` (not the pseudo centres, as in the reference). Returns
    (loss_sum, labels, aux) as the supervised counterpart, the aux also
    holding the shared label and assignment."""
    loss_sum, labels, aux = compute_objectness_loss_query_points(
        end_points, num_decoder_layers, weak=True)
    label, assignment = labels[_prefixes(num_decoder_layers)[0]]
    aux = dict(aux, unlabeled_objectness_label=label,
               unlabeled_object_assignment=assignment)
    return loss_sum, labels, aux


def compute_box_and_sem_cls_loss_pseudo(end_points, config,
                                        num_decoder_layers, labels,
                                        **reg_kwargs):
    """`loss_helper.py:960-1080`: the per-head box and semantic losses
    against the ``unlabeled_*`` pseudo labels."""
    return compute_box_and_sem_cls_loss(
        end_points, config, num_decoder_layers, labels,
        label_key_prefix="unlabeled_", **reg_kwargs)


def get_pseudo_detection_loss(end_points, config, num_decoder_layers,
                              box_loss_coef, sem_cls_loss_coef,
                              **reg_kwargs):
    """`loss_helper.py:1083-1107`: box and semantic pseudo losses over the
    heads (the objectness sum is logged, not added, as in the
    reference)."""
    obj_loss_sum, labels, aux = compute_objectness_loss_query_points_pseudo(
        end_points, num_decoder_layers)
    aux["sum_heads_objectness_loss"] = obj_loss_sum
    box_loss_sum, sem_cls_loss_sum, box_aux = (
        compute_box_and_sem_cls_loss_pseudo(
            end_points, config, num_decoder_layers, labels, **reg_kwargs))
    aux.update(box_aux)
    aux["sum_heads_box_loss"] = box_loss_sum
    aux["sum_heads_sem_cls_loss"] = sem_cls_loss_sum
    loss = (1.0 / (num_decoder_layers + 1)
            * (box_loss_coef * box_loss_sum
               + sem_cls_loss_coef * sem_cls_loss_sum)) * 10.0
    aux["unlabeled_detection_loss"] = loss
    return loss, aux


PSEUDO_LABEL_KEYS = ("box_label_mask", "center_label", "sem_cls_label",
                     "heading_class_label", "heading_residual_label",
                     "size_class_label", "size_residual_label")


@spanned("loss")
def get_loss_pseudo(end_points, end_points_teacher, config, config_dict,
                    num_decoder_layers, box_loss_coef, sem_cls_loss_coef,
                    teacher_prefix="4head_", **reg_kwargs):
    """`loss_helper.py:1110-1146`: teacher -> student consistency.

    The batch is ordered [labeled..., unlabeled...] (`supervised_mask`
    marks the labeled rows). The teacher's `teacher_prefix` head on the
    unlabeled rows gives the pseudo labels (`get_pseudo_labels`, on the
    host), and the student's heads on those rows are trained against
    them."""
    supervised_mask = _host(end_points["supervised_mask"])
    labeled_num = int((supervised_mask != 0).sum())
    tp_ = teacher_prefix
    *labels, aux0 = get_pseudo_labels(
        *(_host(end_points_teacher[f"{tp_}{name}"])[labeled_num:]
          for name in ("center", "sem_cls_scores", "objectness_scores",
                       "heading_scores", "heading_residuals",
                       "size_scores", "size_residuals")),
        config_dict)

    # the student's tensors on the unlabeled rows, and the pseudo labels
    rows = supervised_mask.shape[0]
    sub = {k: v[labeled_num:] for k, v in end_points.items()
           if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == rows}
    device = end_points_teacher[f"{tp_}center"].device
    sub.update({f"unlabeled_{k}": torch.as_tensor(v, device=device)
                for k, v in zip(PSEUDO_LABEL_KEYS, labels)})
    consistency_loss, aux = get_pseudo_detection_loss(
        sub, config, num_decoder_layers, box_loss_coef, sem_cls_loss_coef,
        **reg_kwargs)
    aux.update(aux0)
    return consistency_loss, aux
