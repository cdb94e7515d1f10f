"""Shared loss primitives.

Counterpart of ``backtoreality_tpu/losses/common.py``, with the same
float32 casts (class weights, masks, one-hot), so that a float64 run
matches the JAX package's x64 run to rounding.
"""

from __future__ import annotations

import numpy as np
import torch


def take_rows(x, index):
    """take_along_axis on axis 1: x (B, N, ...) by index (B, K)."""
    index = index.long()
    if x.dim() > 2:
        index = index.reshape(index.shape + (1,) * (x.dim() - 2)).expand(
            -1, -1, *x.shape[2:])
    return torch.gather(x, 1, index)


def masked_mean(x, mask, eps: float = 1e-6):
    """sum(x*mask)/(sum(mask)+eps) — the reference's pervasive reduction."""
    mask = mask.to(torch.float32)
    return torch.sum(x * mask) / (torch.sum(mask) + eps)


def softmax_ce(logits, labels, class_weights=None):
    """Per-element cross entropy (torch CrossEntropyLoss reduction='none').

    logits (..., C); labels (...) int. With class_weights (C,), each
    element's loss is scaled by the weight of its true class.
    """
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    if class_weights is not None:
        # non_blocking: a host constant needs no stream sync
        w = torch.as_tensor(class_weights, dtype=torch.float32).to(
            logits.device, non_blocking=True)[labels]
        nll = nll * w
    return nll


def sigmoid_bce_with_logits(logits, targets):
    """Numerically-stable BCE-with-logits (tf/torch formulation)."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def softmax_focal_loss(logits, labels, gamma: float = 2.0,
                       eps: float = 1e-12):
    """Reference `FocalLoss` softmax branch with alpha=1
    (`loss_helper.py:467-546`): -(1-p)^gamma log p, mean-reduced."""
    p = torch.softmax(logits, dim=-1)
    pt = torch.gather(p, -1, labels.long()[..., None])[..., 0]
    return torch.mean(-((1.0 - pt) ** gamma) * torch.log(pt + eps))


def one_hot_f32(labels, num: int):
    """float32 one-hot; labels outside [0, num) give a zero row."""
    labels = labels.long()
    classes = torch.arange(num, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


def compute_jitter_loss(end_points):
    """MSE(jitter_pred, center_jitter): the CenterRefine jitter loss."""
    return torch.mean(torch.square(end_points["center_jitter"]
                                   - end_points["jitter_pred"]))


def refine_center_labels(end_points_S, end_points_T, epoch,
                         ramp_epochs: float):
    """CenterRefine label refinement: subtract the jitter (the source's GT
    one, the target's prediction, detached) from the weak centres, ramped
    by min(epoch / ramp_epochs, 1) (VoteNet 60, GroupFree3D 120). The ramp
    is rounded as the JAX step computes it from its float32 epoch. Returns
    updated end_points dicts (functional; the reference mutates in
    place)."""
    ramp = float(min(np.float32(epoch) / np.float32(ramp_epochs),
                     np.float32(1.0)))
    new_S = dict(end_points_S)
    new_T = dict(end_points_T)
    new_S["center_label"] = (end_points_S["center_label"]
                             - ramp * end_points_S["center_jitter"])
    refined_T = (end_points_T["center_label"]
                 - ramp * end_points_T["jitter_pred"]
                 * end_points_T["box_label_mask"][..., None])
    new_T["center_label"] = refined_T.detach()
    return new_S, new_T
