"""PointNet++ backbone for VoteNet.

Counterpart of ``Pointnet2Backbone`` in
``backtoreality_tpu/models/votenet/backbone.py`` (reference
`backbone_module.py:21-133`): 4 single-scale SA layers
(2048/0.2/64 -> 1024/0.4/32 -> 512/0.8/16 -> 256/1.2/16) + 2 FP layers
back to 1024 seeds @ 256 channels. ``Pointnet2BackboneJitter`` adds the
centre-grouping head of the CenterRefine model (`backbone_module.py:
136-262`); ``Pointnet2BackboneCam`` is the SA layers alone
(`backbone_module.py:265-367`). The stages compute in `dtype` (None: the
parameters', float32), but for the last `f32_tail` of them, which compute
in float32 (:func:`stage_dtype`).
"""

from __future__ import annotations

import torch
from torch import nn

from backtoreality_tpu_torch.nn import (FPModule, SAModuleCenters,
                                        SAModuleVotes)


def stage_dtype(dtype: torch.dtype | None, f32_tail: int, idx: int):
    """The compute dtype of backbone stage `idx` (0..5 over sa1..sa4, fp1,
    fp2): the last `f32_tail` stages (fp2, fp1, sa4, ...) run in float32
    whatever `dtype` (``Pointnet2Backbone._stage_dtype`` of the JAX
    package); None is the parameters' dtype, float32."""
    return None if 6 - idx <= f32_tail else dtype


def _sa_layers(input_feature_dim, query_mode, fps_candidates, dtypes):
    """VoteNet's four SA layers, SA1 sampling over `fps_candidates`, each
    computing in its entry of `dtypes`."""
    return (
        SAModuleVotes(npoint=2048, radius=0.2, nsample=64,
                      in_features=input_feature_dim, mlp=[64, 64, 128],
                      query_mode=query_mode, fps_candidates=fps_candidates,
                      dtype=dtypes[0]),
        SAModuleVotes(npoint=1024, radius=0.4, nsample=32, in_features=128,
                      mlp=[128, 128, 256], query_mode=query_mode,
                      dtype=dtypes[1]),
        SAModuleVotes(npoint=512, radius=0.8, nsample=16, in_features=256,
                      mlp=[128, 128, 256], query_mode=query_mode,
                      dtype=dtypes[2]),
        SAModuleVotes(npoint=256, radius=1.2, nsample=16, in_features=256,
                      mlp=[128, 128, 256], query_mode=query_mode,
                      dtype=dtypes[3]))


class Pointnet2Backbone(nn.Module):
    def __init__(self, input_feature_dim: int = 0,
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None, f32_tail: int = 0):
        super().__init__()

        def dt(idx):
            return stage_dtype(dtype, f32_tail, idx)

        self.sa1, self.sa2, self.sa3, self.sa4 = _sa_layers(
            input_feature_dim, query_mode, fps_candidates,
            [dt(i) for i in range(4)])
        self.fp1 = FPModule(256 + 256, mlp=[256, 256], dtype=dt(4))
        self.fp2 = FPModule(256 + 256, mlp=[256, 256], dtype=dt(5))

    def forward(self, pointcloud, end_points=None):
        """pointcloud: (B, N, 3 + input_feature_dim). Returns end_points
        with sa*/fp2 xyz/features/inds (features channels-last)."""
        if end_points is None:
            end_points = {}
        xyz = pointcloud[..., 0:3]
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None

        xyz, features, inds = self.sa1(xyz, features)
        end_points["sa1_inds"] = inds
        end_points["sa1_xyz"] = xyz
        end_points["sa1_features"] = features

        xyz, features, inds = self.sa2(xyz, features)
        end_points["sa2_inds"] = inds
        end_points["sa2_xyz"] = xyz
        end_points["sa2_features"] = features

        xyz, features, inds = self.sa3(xyz, features)
        end_points["sa3_xyz"] = xyz
        end_points["sa3_features"] = features

        xyz, features, inds = self.sa4(xyz, features)
        end_points["sa4_xyz"] = xyz
        end_points["sa4_features"] = features

        features = self.fp1(
            end_points["sa3_xyz"], end_points["sa4_xyz"],
            end_points["sa3_features"], end_points["sa4_features"])
        features = self.fp2(
            end_points["sa2_xyz"], end_points["sa3_xyz"],
            end_points["sa2_features"], features)
        end_points["fp2_features"] = features
        end_points["fp2_xyz"] = end_points["sa2_xyz"]
        num_seed = end_points["fp2_xyz"].shape[1]
        # seed indices into the original cloud (`backbone_module.py:132`)
        end_points["fp2_inds"] = end_points["sa1_inds"][:, 0:num_seed]
        return end_points


class Pointnet2BackboneCam(nn.Module):
    """SA-only backbone (`Pointnet2Backbone_cam`, `backbone_module.py:
    265-367`; on no recipe's path: the class-activation-map model it fed
    was removed from the reference): the same four SA layers, all in
    `dtype`, and no FP layers. end_points carries ``sa{1..4}_xyz`` and
    ``sa{1..4}_features``, and ``sa1_inds``, ``sa2_inds``."""

    def __init__(self, input_feature_dim: int = 0,
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.sa1, self.sa2, self.sa3, self.sa4 = _sa_layers(
            input_feature_dim, query_mode, fps_candidates, [dtype] * 4)

    def forward(self, pointcloud, end_points=None):
        """pointcloud: (B, N, 3 + input_feature_dim)."""
        if end_points is None:
            end_points = {}
        xyz = pointcloud[..., 0:3]
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        for i, sa in enumerate((self.sa1, self.sa2, self.sa3, self.sa4),
                               start=1):
            xyz, features, inds = sa(xyz, features)
            if i <= 2:
                end_points[f"sa{i}_inds"] = inds
            end_points[f"sa{i}_xyz"] = xyz
            end_points[f"sa{i}_features"] = features
        return end_points


class Pointnet2BackboneJitter(nn.Module):
    """Backbone + centre-jitter head (`Pointnet2Backbone_jitter`,
    `backbone_module.py:136-262`): groups the FP2 seed features (at the
    sa2 positions) around given GT centres and appends the class one-hot,
    giving `center_features` for the jitter-prediction net."""

    def __init__(self, num_class: int = 22, input_feature_dim: int = 0,
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None, f32_tail: int = 0):
        super().__init__()
        self.num_class = num_class
        self.backbone = Pointnet2Backbone(
            input_feature_dim=input_feature_dim, query_mode=query_mode,
            fps_candidates=fps_candidates, dtype=dtype, f32_tail=f32_tail)
        # 64 centres at most, r=0.8, ONE mlp layer 256(+3 xyz) -> 128,
        # no radius normalization (`backbone_module.py:187-195`); in
        # `dtype`, whatever the tail
        self.ctjt = SAModuleCenters(radius=0.8, nsample=16, in_features=256,
                                    mlp=[128], query_mode=query_mode,
                                    dtype=dtype)

    def forward(self, pointcloud, center_label, sem_cls_label,
                end_points=None):
        """center_label (B, K, 3) GT centres; sem_cls_label (B, K) int.

        Adds `center_features` (B, K, 128 + num_class) to end_points
        (`backbone_module.py:257-260`)."""
        end_points = self.backbone(pointcloud, end_points)
        feats = self.ctjt(end_points["sa2_xyz"], end_points["fp2_features"],
                          center_label)
        onehot = torch.eye(self.num_class, dtype=feats.dtype,
                           device=feats.device)[sem_cls_label.long()]
        end_points["center_features"] = torch.cat([feats, onehot], dim=-1)
        return end_points
