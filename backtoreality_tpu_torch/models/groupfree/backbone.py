"""GroupFree3D PointNet++ backbone
(`detection/GroupFree3D/models/backbone_module.py:21-138`).

Counterpart of ``backtoreality_tpu/models/groupfree/backbone.py``: the
4 x SA + 2 x FP topology of VoteNet's backbone with a width multiplier,
fp2 emitting 288 channels (the transformer's width). The stages compute
in `dtype` but for the last `f32_tail`, in float32, as VoteNet's
(`models.votenet.backbone.stage_dtype`). The spans are VoteNet's
(``model.backbone``, ``model.backbone.sa1`` ... ``.fp2``).
"""

from __future__ import annotations

import torch
from torch import nn

from backtoreality_tpu_torch.models.votenet.backbone import stage_dtype
from backtoreality_tpu_torch.nn import FPModule, SAModuleVotes
from backtoreality_tpu_torch.train.observability import span


class GFBackbone(nn.Module):
    def __init__(self, input_feature_dim: int = 0, width: int = 1,
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None, f32_tail: int = 0):
        super().__init__()
        w = width
        kw = dict(query_mode=query_mode)

        def dt(idx):
            return stage_dtype(dtype, f32_tail, idx)

        self.sa1 = SAModuleVotes(
            npoint=2048, radius=0.2, nsample=64,
            in_features=input_feature_dim, mlp=[64 * w] * 2 + [128 * w],
            fps_candidates=fps_candidates, dtype=dt(0), **kw)
        self.sa2 = SAModuleVotes(
            npoint=1024, radius=0.4, nsample=32, in_features=128 * w,
            mlp=[128 * w] * 2 + [256 * w], dtype=dt(1), **kw)
        self.sa3 = SAModuleVotes(
            npoint=512, radius=0.8, nsample=16, in_features=256 * w,
            mlp=[128 * w] * 2 + [256 * w], dtype=dt(2), **kw)
        self.sa4 = SAModuleVotes(
            npoint=256, radius=1.2, nsample=16, in_features=256 * w,
            mlp=[128 * w] * 2 + [256 * w], dtype=dt(3), **kw)
        self.fp1 = FPModule(512 * w, mlp=[256 * w, 256 * w], dtype=dt(4))
        self.fp2 = FPModule(512 * w, mlp=[256 * w, 288], dtype=dt(5))

    def forward(self, pointcloud, end_points=None):
        """pointcloud (B, N, 3 + input_feature_dim). Returns end_points
        with the sa*/fp2 positions, features and indices; fp2_features
        (B, 1024, 288)."""
        if end_points is None:
            end_points = {}
        xyz = pointcloud[..., 0:3]
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None

        with span("model.backbone"):
            with span("model.backbone.sa1"):
                xyz, features, inds = self.sa1(xyz, features)
            end_points["sa1_inds"] = inds
            end_points["sa1_xyz"] = xyz
            end_points["sa1_features"] = features

            with span("model.backbone.sa2"):
                xyz, features, inds = self.sa2(xyz, features)
            end_points["sa2_inds"] = inds
            end_points["sa2_xyz"] = xyz
            end_points["sa2_features"] = features

            with span("model.backbone.sa3"):
                xyz, features, _ = self.sa3(xyz, features)
            end_points["sa3_xyz"] = xyz
            end_points["sa3_features"] = features

            with span("model.backbone.sa4"):
                xyz, features, _ = self.sa4(xyz, features)
            end_points["sa4_xyz"] = xyz
            end_points["sa4_features"] = features

            with span("model.backbone.fp1"):
                features = self.fp1(
                    end_points["sa3_xyz"], end_points["sa4_xyz"],
                    end_points["sa3_features"], end_points["sa4_features"])
            with span("model.backbone.fp2"):
                features = self.fp2(
                    end_points["sa2_xyz"], end_points["sa3_xyz"],
                    end_points["sa2_features"], features)
        end_points["fp2_features"] = features
        end_points["fp2_xyz"] = end_points["sa2_xyz"]
        num_seed = end_points["fp2_xyz"].shape[1]
        end_points["fp2_inds"] = end_points["sa1_inds"][:, 0:num_seed]
        return end_points
