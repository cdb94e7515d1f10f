"""VoteNet training criteria: FSB, WSB, BR and BR+CenterRefine, and the
experimental BoxNet, separate-DA and CAM criteria.

Counterpart of ``backtoreality_tpu/losses/votenet.py`` (reference
`detection/Votenet/models/loss_helper.py`: constants :19-22, vote losses
:24-109, objectness :111-152, box :154-228, weak centre :242-304,
compositions :336-464, DA :548-664, jitter :667-803, separate DA
:806-907, CAM :910-1039; `loss_helper_boxnet.py`). Every function takes
`end_points` (model outputs merged with the GT labels, channels-last) and
each criterion returns ``(loss, aux)``, where aux holds every scalar the
reference logs plus the label tensors downstream code needs. Nothing is
mutated. `get_loss_cam` and `get_loss_DA_cam` read ``cam`` and
``vote_feature_d_pred``, which no model of either package produces.

Label keys (from the data pipeline, the reference's names):
  center_label (B,K2,3), box_label_mask (B,K2), sem_cls_label (B,K2),
  heading_class_label (B,K2), heading_residual_label (B,K2),
  size_class_label (B,K2), size_residual_label (B,K2,3),
  vote_label (B,N,9), vote_label_mask (B,N), center_jitter (B,K2,3),
  cloud_label (B,num_class).
"""

from __future__ import annotations

import math

import torch

from backtoreality_tpu_torch.losses.common import (compute_jitter_loss,
                                                   masked_mean, one_hot_f32,
                                                   refine_center_labels,
                                                   sigmoid_bce_with_logits,
                                                   softmax_ce,
                                                   softmax_focal_loss)
from backtoreality_tpu_torch.losses.common import take_rows as _take
from backtoreality_tpu_torch.ops import huber_loss, nn_distance

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)


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


def compute_weak_vote_loss(end_points):
    """`loss_helper.py:71-109`: bidirectional chamfer between votes and
    (weak) GT centres — mean vote->centre plus masked centre->vote."""
    b, num_seed, _ = end_points["seed_xyz"].shape
    gt_center = end_points["center_label"][:, :, 0:3]
    dist1, _, dist2, _ = nn_distance(end_points["vote_xyz"], gt_center,
                                     l1=True)
    votes_dist = torch.amin(dist1.reshape(b, num_seed, -1), dim=2)
    return (torch.mean(votes_dist)
            + masked_mean(dist2, end_points["box_label_mask"]))


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


def compute_center_and_sem_cls_loss(end_points, config):
    """`loss_helper.py:242-304` — the weak-label variant: centre chamfer
    + size cls + sem cls only (weak labels carry centres + classes)."""
    assignment = end_points["object_assignment"]
    objectness_label = end_points["objectness_label"].to(torch.float32)

    gt_center = end_points["center_label"][:, :, 0:3]
    dist1, _, dist2, _ = nn_distance(end_points["center"], gt_center)
    center_loss = (masked_mean(dist1, objectness_label)
                   + masked_mean(dist2, end_points["box_label_mask"]))

    size_class_label = _take(end_points["size_class_label"], assignment)
    size_class_loss = masked_mean(
        softmax_ce(end_points["size_scores"], size_class_label),
        objectness_label)

    sem_cls_label = _take(end_points["sem_cls_label"], assignment)
    sem_cls_loss = masked_mean(
        softmax_ce(end_points["sem_cls_scores"], sem_cls_label),
        objectness_label)
    return center_loss, size_class_loss, sem_cls_loss


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


def get_loss_weak(end_points, config):
    """WSB criterion (`loss_helper.py:403-464`). Returns (loss, aux)."""
    aux = {}
    vote_loss = compute_weak_vote_loss(end_points)
    aux["vote_loss"] = vote_loss

    (objectness_loss, objectness_label, objectness_mask,
     object_assignment) = compute_objectness_loss(end_points)
    aux["objectness_loss"] = objectness_loss
    aux["objectness_label"] = objectness_label
    aux["objectness_mask"] = objectness_mask
    aux["object_assignment"] = object_assignment
    end_points = dict(end_points, objectness_label=objectness_label,
                      object_assignment=object_assignment)

    center_loss, size_cls_loss, sem_cls_loss = (
        compute_center_and_sem_cls_loss(end_points, config))
    box_loss = center_loss + 0.1 * size_cls_loss
    aux.update(center_loss=center_loss, size_cls_loss=size_cls_loss,
               sem_cls_loss=sem_cls_loss, box_loss=box_loss)

    loss = (vote_loss + 0.5 * objectness_loss + box_loss
            + 0.1 * sem_cls_loss) * 10.0
    aux["loss"] = loss

    pos_ratio, neg_ratio, obj_acc = _objectness_stats(
        end_points, objectness_label, objectness_mask)
    aux.update(pos_ratio=pos_ratio, neg_ratio=neg_ratio, obj_acc=obj_acc)
    return loss, aux


def compute_sem_cls_loss(end_points, config):
    """Scene-level multi-label semantic loss (`loss_helper.py:306-333`):
    BCE between the mean-pooled per-proposal class logits and the scene
    class-indicator vector (`cloud_label`)."""
    del config
    cloud_label = end_points["cloud_label"].to(torch.float32)
    cloud_pred = torch.mean(end_points["sem_cls_scores"], dim=1)
    return torch.mean(sigmoid_bce_with_logits(cloud_pred, cloud_label))


def compute_objectness_loss_boxnet(end_points):
    """BoxNet objectness (`loss_helper_boxnet.py:20-61`): the label is
    the seed's GT vote mask gathered through the aggregation indices, no
    near/far don't-care zone. Returns (loss, label, mask, assignment)."""
    gt_center = end_points["center_label"][:, :, 0:3]
    _, ind1, _, _ = nn_distance(end_points["aggregated_vote_xyz"],
                                gt_center)
    seed_labels = _take(end_points["vote_label_mask"],
                        end_points["seed_inds"])
    objectness_label = _take(seed_labels,
                             end_points["aggregated_vote_inds"]).to(
        torch.int32)
    objectness_mask = torch.ones_like(objectness_label,
                                      dtype=torch.float32)
    loss = softmax_ce(end_points["objectness_scores"], objectness_label,
                      OBJECTNESS_CLS_WEIGHTS)
    loss = masked_mean(loss, objectness_mask)
    return loss, objectness_label, objectness_mask, ind1


def get_loss_boxnet(end_points, config):
    """BoxNet criterion (`loss_helper_boxnet.py:64-122`): no vote loss,
    (0.5 obj + box + 0.1 sem) * 10. Returns (loss, aux)."""
    aux = {}
    (objectness_loss, objectness_label, objectness_mask,
     object_assignment) = compute_objectness_loss_boxnet(end_points)
    aux.update(objectness_loss=objectness_loss,
               objectness_label=objectness_label,
               objectness_mask=objectness_mask,
               object_assignment=object_assignment)
    end_points = dict(end_points, objectness_label=objectness_label,
                      object_assignment=object_assignment)

    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss,
     size_reg_loss, sem_cls_loss) = compute_box_and_sem_cls_loss(
         end_points, config)
    box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss
                + 0.1 * size_cls_loss + size_reg_loss)
    aux.update(center_loss=center_loss, box_loss=box_loss,
               sem_cls_loss=sem_cls_loss)

    loss = (0.5 * objectness_loss + box_loss + 0.1 * sem_cls_loss) * 10.0
    aux["loss"] = loss
    pos_ratio, neg_ratio, obj_acc = _objectness_stats(
        end_points, objectness_label, objectness_mask)
    aux.update(pos_ratio=pos_ratio, neg_ratio=neg_ratio, obj_acc=obj_acc)
    return loss, aux


SOURCE_COEFFICIENT = 0.1
DA_COEFFICIENT = 0.5


def _domain_align_loss(end_points_S, end_points_T, objectness_label_S,
                       objectness_label_T):
    """`loss_helper.py:625-654`: local L2-to-domain on objectness-positive
    proposals + global focal (gamma=3), both behind grad reversal."""
    global_S = end_points_S["global_d_pred"]  # (B, 2)
    local_S = end_points_S["local_d_pred"]  # (B, K, 1)
    domain_S = torch.zeros(global_S.shape[0], dtype=torch.int64,
                           device=global_S.device)
    w_S = objectness_label_S[..., None].to(torch.float32)
    source_dloss = (
        DA_COEFFICIENT * torch.mean(torch.square(local_S) * w_S)
        + DA_COEFFICIENT * softmax_focal_loss(global_S, domain_S, gamma=3))

    global_T = end_points_T["global_d_pred"]
    local_T = end_points_T["local_d_pred"]
    domain_T = torch.ones(global_T.shape[0], dtype=torch.int64,
                          device=global_T.device)
    w_T = objectness_label_T[..., None].to(torch.float32)
    target_dloss = (
        DA_COEFFICIENT * torch.mean(torch.square(1.0 - local_T) * w_T)
        + DA_COEFFICIENT * softmax_focal_loss(global_T, domain_T, gamma=3))
    return source_dloss + target_dloss


def _da_supervised_parts(end_points_S, end_points_T, config, aux):
    """Shared S(full)+T(weak) supervision of get_loss_DA{,_jitter}
    (`loss_helper.py:572-623`). Returns the component sums and the
    objectness labels."""
    vote_loss_S = compute_weak_vote_loss(end_points_S)
    vote_loss_T = compute_weak_vote_loss(end_points_T)
    vote_loss = SOURCE_COEFFICIENT * vote_loss_S + vote_loss_T
    aux.update(vote_loss_S=vote_loss_S, vote_loss_T=vote_loss_T)

    (objectness_loss_S, objectness_label_S, objectness_mask_S,
     assignment_S) = compute_objectness_loss(end_points_S)
    (objectness_loss_T, objectness_label_T, _,
     assignment_T) = compute_objectness_loss(end_points_T)
    objectness_loss = (SOURCE_COEFFICIENT * objectness_loss_S
                       + objectness_loss_T)
    aux.update(objectness_loss_S=objectness_loss_S,
               objectness_loss_T=objectness_loss_T)

    ep_S = dict(end_points_S, objectness_label=objectness_label_S,
                object_assignment=assignment_S)
    ep_T = dict(end_points_T, objectness_label=objectness_label_T,
                object_assignment=assignment_T)

    (center_loss_S, heading_cls_loss, heading_reg_loss, size_cls_loss_S,
     size_reg_loss, sem_cls_loss_S) = compute_box_and_sem_cls_loss(
         ep_S, config)
    box_loss_S = (center_loss_S + 0.1 * heading_cls_loss
                  + heading_reg_loss + 0.1 * size_cls_loss_S
                  + size_reg_loss)
    center_loss_T, size_cls_loss_T, sem_cls_loss_T = (
        compute_center_and_sem_cls_loss(ep_T, config))
    box_loss_T = center_loss_T + 0.1 * size_cls_loss_T

    box_loss = SOURCE_COEFFICIENT * box_loss_S + box_loss_T
    sem_cls_loss = SOURCE_COEFFICIENT * sem_cls_loss_S + sem_cls_loss_T
    aux.update(center_loss_S=center_loss_S, center_loss_T=center_loss_T,
               box_loss_S=box_loss_S, box_loss_T=box_loss_T)

    pos_ratio, neg_ratio, obj_acc = _objectness_stats(
        end_points_S, objectness_label_S, objectness_mask_S)
    aux.update(pos_ratio=pos_ratio, neg_ratio=neg_ratio, obj_acc=obj_acc)
    return (vote_loss, objectness_loss, box_loss, sem_cls_loss,
            objectness_label_S, objectness_label_T)


def get_loss_DA(end_points_S, end_points_T, config):
    """BR criterion (`loss_helper.py:548-664`): 0.1 x full-supervised
    source + weak target + domain alignment. Returns (loss, aux)."""
    aux = {}
    (vote_loss, objectness_loss, box_loss, sem_cls_loss,
     objectness_label_S, objectness_label_T) = _da_supervised_parts(
         end_points_S, end_points_T, config, aux)
    da_loss = _domain_align_loss(end_points_S, end_points_T,
                                 objectness_label_S, objectness_label_T)
    aux["da_loss"] = da_loss
    loss = (vote_loss + 0.5 * objectness_loss + box_loss
            + 0.1 * sem_cls_loss + da_loss) * 10.0
    aux["loss"] = loss
    return loss, aux


def get_loss_DA_jitter(end_points_S, end_points_T, epoch, config):
    """BR+CenterRefine criterion (`loss_helper.py:675-803`); `epoch` is a
    host number. Returns (loss, aux)."""
    end_points_S, end_points_T = refine_center_labels(
        end_points_S, end_points_T, epoch, ramp_epochs=60)

    aux = {}
    jitter_loss_S = compute_jitter_loss(end_points_S)
    aux["jitter_loss_S"] = jitter_loss_S

    (vote_loss, objectness_loss, box_loss, sem_cls_loss,
     objectness_label_S, objectness_label_T) = _da_supervised_parts(
         end_points_S, end_points_T, config, aux)
    da_loss = _domain_align_loss(end_points_S, end_points_T,
                                 objectness_label_S, objectness_label_T)
    aux["da_loss"] = da_loss
    loss = (vote_loss + 0.5 * objectness_loss + box_loss
            + 0.1 * sem_cls_loss + da_loss
            + SOURCE_COEFFICIENT * jitter_loss_S) * 10.0
    aux["loss"] = loss
    return loss, aux


def _positive_weight(end_points):
    """Each proposal's positive-objectness softmax, (B, K, 1)."""
    return torch.softmax(end_points["objectness_scores"], -1)[..., 1:]


def get_loss_DA_separate(end_points_S, end_points_T, config):
    """Experimental DA variant (`loss_helper.py:806-907`; on no recipe's
    path). Against `get_loss_DA`: both domains weigh equally (no 0.1
    source coefficient), the source keeps the full seed-vote loss
    (`compute_vote_loss`), and the alignment is the local per-proposal
    L2-to-domain term alone at coefficient 1.0 (`:887-897`), each proposal
    weighted by its positive-objectness softmax. Returns (loss, aux)."""
    aux = {}
    vote_loss_S = compute_vote_loss(end_points_S)
    vote_loss_T = compute_weak_vote_loss(end_points_T)
    vote_loss = vote_loss_S + vote_loss_T
    aux.update(vote_loss_S=vote_loss_S, vote_loss_T=vote_loss_T)

    (objectness_loss_S, objectness_label_S, objectness_mask_S,
     assignment_S) = compute_objectness_loss(end_points_S)
    (objectness_loss_T, objectness_label_T, _,
     assignment_T) = compute_objectness_loss(end_points_T)
    objectness_loss = objectness_loss_S + objectness_loss_T
    aux.update(objectness_loss_S=objectness_loss_S,
               objectness_loss_T=objectness_loss_T)

    ep_S = dict(end_points_S, objectness_label=objectness_label_S,
                object_assignment=assignment_S)
    ep_T = dict(end_points_T, objectness_label=objectness_label_T,
                object_assignment=assignment_T)
    (center_loss_S, heading_cls_loss, heading_reg_loss, size_cls_loss_S,
     size_reg_loss, sem_cls_loss_S) = compute_box_and_sem_cls_loss(
         ep_S, config)
    center_loss_T, size_cls_loss_T, sem_cls_loss_T = (
        compute_center_and_sem_cls_loss(ep_T, config))
    box_loss = (center_loss_S + 0.1 * heading_cls_loss + heading_reg_loss
                + 0.1 * size_cls_loss_S + size_reg_loss
                + center_loss_T + 0.1 * size_cls_loss_T)
    sem_cls_loss = sem_cls_loss_S + sem_cls_loss_T
    aux.update(center_loss_S=center_loss_S, center_loss_T=center_loss_T,
               sem_cls_loss=sem_cls_loss, box_loss=box_loss)

    # source pushed to 0, target to 1
    da_loss = (torch.mean(torch.square(end_points_S["local_d_pred"])
                          * _positive_weight(end_points_S))
               + torch.mean(torch.square(1.0 - end_points_T["local_d_pred"])
                            * _positive_weight(end_points_T)))
    aux["da_loss"] = da_loss

    loss = (vote_loss + 0.5 * objectness_loss + box_loss
            + 0.1 * sem_cls_loss + da_loss) * 10.0
    aux["loss"] = loss
    pos_ratio, neg_ratio, obj_acc = _objectness_stats(
        end_points_S, objectness_label_S, objectness_mask_S)
    aux.update(pos_ratio=pos_ratio, neg_ratio=neg_ratio, obj_acc=obj_acc)
    return loss, aux


def get_loss_cam(end_points, config):
    """Class-activation-map pretext loss (`loss_helper.py:910-943`; the
    model that produced ``cam`` was removed from the reference): BCE
    between the globally average-pooled per-class activation map (B, K,
    num_class, channels-last) and the scene class-indicator vector.
    Returns (loss, aux)."""
    del config
    cam_gap = torch.mean(end_points["cam"], dim=1)  # (B, num_class)
    cloud_label = end_points["cloud_label"].to(torch.float32)
    loss = torch.mean(sigmoid_bce_with_logits(cam_gap, cloud_label))
    return loss, {"loss": loss}


def _cam_domain_loss(end_points, domain_value, flip_local):
    """The three alignment terms of `get_loss_DA_cam`: local L2 (weighted
    by positive objectness), global focal (gamma 5) and vote-feature focal
    (gamma 3), each at 0.5."""
    global_d = end_points["global_d_pred"]
    local_d = end_points["local_d_pred"]
    domain = torch.full((global_d.shape[0],), domain_value,
                        dtype=torch.int64, device=global_d.device)
    local = 1.0 - local_d if flip_local else local_d
    return (0.5 * torch.mean(torch.square(local)
                             * _positive_weight(end_points))
            + 0.5 * softmax_focal_loss(global_d, domain, gamma=5)
            + 0.5 * softmax_focal_loss(end_points["vote_feature_d_pred"],
                                       domain, gamma=3))


def get_loss_DA_cam(end_points_S, end_points_T, config):
    """CAM-augmented DA variant (`loss_helper.py:946-1039`): full
    supervision on the source (the full seed-vote loss included), the
    scene-level semantic loss on the target (`compute_sem_cls_loss`,
    weighted 2x), and a three-term alignment (`_cam_domain_loss`). Needs
    ``vote_feature_d_pred`` (B, 2). Returns (loss, aux)."""
    aux = {}
    vote_loss = compute_vote_loss(end_points_S)
    aux["vote_loss"] = vote_loss

    (objectness_loss, objectness_label_S, objectness_mask_S,
     assignment_S) = compute_objectness_loss(end_points_S)
    aux["objectness_loss"] = objectness_loss

    ep_S = dict(end_points_S, objectness_label=objectness_label_S,
                object_assignment=assignment_S)
    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss,
     size_reg_loss, sem_cls_loss_S) = compute_box_and_sem_cls_loss(
         ep_S, config)
    box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss
                + 0.1 * size_cls_loss + size_reg_loss)
    sem_cls_loss_T = compute_sem_cls_loss(end_points_T, config)
    sem_cls_loss = sem_cls_loss_S + 2.0 * sem_cls_loss_T
    aux.update(box_loss=box_loss, sem_cls_loss_T=sem_cls_loss_T)

    da_loss = (_cam_domain_loss(end_points_S, 0, False)
               + _cam_domain_loss(end_points_T, 1, True))
    aux["da_loss"] = da_loss

    loss = (vote_loss + 0.5 * objectness_loss + box_loss
            + 0.1 * sem_cls_loss + da_loss) * 10.0
    aux["loss"] = loss
    pos_ratio, neg_ratio, obj_acc = _objectness_stats(
        end_points_S, objectness_label_S, objectness_mask_S)
    aux.update(pos_ratio=pos_ratio, neg_ratio=neg_ratio, obj_acc=obj_acc)
    return loss, aux
