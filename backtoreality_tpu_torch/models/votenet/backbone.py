"""PointNet++ backbone for VoteNet.

Counterpart of ``Pointnet2Backbone`` in
``backtoreality_tpu/models/votenet/backbone.py`` (reference
`backbone_module.py:21-133`): 4 single-scale SA layers
(2048/0.2/64 -> 1024/0.4/32 -> 512/0.8/16 -> 256/1.2/16) + 2 FP layers
back to 1024 seeds @ 256 channels. The bf16 ``f32_tail`` option is not
ported.
"""

from __future__ import annotations

from torch import nn

from backtoreality_tpu_torch.nn import FPModule, SAModuleVotes


class Pointnet2Backbone(nn.Module):
    def __init__(self, input_feature_dim: int = 0,
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None):
        super().__init__()
        kw = dict(query_mode=query_mode)
        self.sa1 = SAModuleVotes(
            npoint=2048, radius=0.2, nsample=64,
            in_features=input_feature_dim, mlp=[64, 64, 128],
            fps_candidates=fps_candidates, **kw)
        self.sa2 = SAModuleVotes(
            npoint=1024, radius=0.4, nsample=32, in_features=128,
            mlp=[128, 128, 256], **kw)
        self.sa3 = SAModuleVotes(
            npoint=512, radius=0.8, nsample=16, in_features=256,
            mlp=[128, 128, 256], **kw)
        self.sa4 = SAModuleVotes(
            npoint=256, radius=1.2, nsample=16, in_features=256,
            mlp=[128, 128, 256], **kw)
        self.fp1 = FPModule(256 + 256, mlp=[256, 256])
        self.fp2 = FPModule(256 + 256, mlp=[256, 256])

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
