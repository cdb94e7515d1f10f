"""GroupFree3D building blocks (`detection/GroupFree3D/models/modules.py:
16-193`).

Counterpart of ``backtoreality_tpu/models/groupfree/modules.py``,
channels-last, submodules named as there: the per-seed objectness scorer
of KPS, the learned position embedding, FPS and index sampling of the
queries, and the per-layer box head. Each computes in its `dtype` (None:
the parameters'); the box head's seven output layers always in float32
(float64 in the parity tests), as the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from backtoreality_tpu_torch import ops
from backtoreality_tpu_torch.nn import BatchNorm, Dense, PointwiseMLP


class PointsObjClsModule(PointwiseMLP):
    """Per-seed objectness scorer for KPS (`modules.py:16-44`):
    (B, num_seed, C) -> (B, num_seed, 1) logits; ``dense0``, ``bn0``,
    ``dense1``, ``bn1`` and ``out``."""

    def __init__(self, feature_dim: int = 288,
                 dtype: torch.dtype | None = None):
        super().__init__(feature_dim, [feature_dim, feature_dim], 1,
                         dtype=dtype)


class PositionEmbeddingLearned(nn.Module):
    """Learned absolute position embedding (`modules.py:47-63`): Linear
    (3 or 6 -> D, no bias) + BN + ReLU + Linear (D -> D)."""

    def __init__(self, input_channel: int, num_pos_feats: int = 288,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dense0 = Dense(input_channel, num_pos_feats, bias=False,
                            dtype=dtype)
        self.bn0 = BatchNorm(num_pos_feats)
        self.dense1 = Dense(num_pos_feats, num_pos_feats, dtype=dtype)

    def forward(self, xyz):
        return self.dense1(torch.relu(self.bn0(self.dense0(xyz))))


def fps_sample(xyz, features, num_proposal):
    """`FPSModule` (`modules.py:66-84`)."""
    inds = ops.furthest_point_sample(xyz, num_proposal)
    return (ops.gather_points(xyz, inds), ops.gather_points(features, inds),
            inds)


def general_sample(xyz, features, sample_inds):
    """`GeneralSamplingModule` (`modules.py:87-100`)."""
    return (ops.gather_points(xyz, sample_inds),
            ops.gather_points(features, sample_inds), sample_inds)


HEADS = ("objectness", "center_residual", "heading_class",
         "heading_residual", "size_class", "size_residual", "sem_cls")


class PredictHead(nn.Module):
    """Per-layer box head (`modules.py:103-193`): a shared 2 x (Linear +
    BN + ReLU), then 7 separate linear heads; objectness is one sigmoid
    logit. Writes the ``{prefix}*`` keys into end_points and returns
    (center, pred_size) for the next layer's position embedding."""

    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr,
                 seed_feat_dim: int = 288, dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        # float32, as the JAX head holds it (also under x64)
        self.mean_size_arr = np.asarray(mean_size_arr, np.float32)
        for i in range(2):
            self.add_module(f"dense{i}", Dense(seed_feat_dim, seed_feat_dim,
                                               bias=False, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(seed_feat_dim))
        nh, ns = num_heading_bin, num_size_cluster
        for name, out in zip(HEADS, (1, 3, nh, nh, ns, ns * 3, num_class)):
            self.add_module(name, Dense(seed_feat_dim, out))

    def forward(self, features, base_xyz, end_points, prefix=""):
        """features (B, K, C); base_xyz (B, K, 3)."""
        nh, ns = self.num_heading_bin, self.num_size_cluster
        net = features
        for i in range(2):
            net = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"dense{i}")(net)))
        # f32 (or f64 in the parity tests), as the JAX heads
        net = net.to(torch.promote_types(net.dtype, torch.float32))
        objectness_scores = self.objectness(net)  # (B, K, 1)
        center = base_xyz + self.center_residual(net)
        heading_scores = self.heading_class(net)
        heading_residuals_normalized = self.heading_residual(net)
        heading_residuals = heading_residuals_normalized * (math.pi / nh)

        # non_blocking: a host constant needs no stream sync
        msa = torch.as_tensor(self.mean_size_arr).to(
            net.device, net.dtype, non_blocking=True)[None, None]
        size_scores = self.size_class(net)
        b, k = features.shape[0], features.shape[1]
        size_residuals_normalized = self.size_residual(net).reshape(
            b, k, ns, 3)
        size_residuals = size_residuals_normalized * msa
        size_recover = size_residuals + msa
        pred_size_class = torch.argmax(size_scores, -1)
        index = pred_size_class[..., None, None].expand(-1, -1, 1, 3)
        pred_size = torch.gather(size_recover, 2, index)[:, :, 0, :]
        sem_cls_scores = self.sem_cls(net)

        end_points[f"{prefix}base_xyz"] = base_xyz
        end_points[f"{prefix}objectness_scores"] = objectness_scores
        end_points[f"{prefix}center"] = center
        end_points[f"{prefix}heading_scores"] = heading_scores
        end_points[f"{prefix}heading_residuals_normalized"] = (
            heading_residuals_normalized)
        end_points[f"{prefix}heading_residuals"] = heading_residuals
        end_points[f"{prefix}size_scores"] = size_scores
        end_points[f"{prefix}size_residuals_normalized"] = (
            size_residuals_normalized)
        end_points[f"{prefix}size_residuals"] = size_residuals
        end_points[f"{prefix}pred_size"] = pred_size
        end_points[f"{prefix}sem_cls_scores"] = sem_cls_scores
        return center, pred_size
