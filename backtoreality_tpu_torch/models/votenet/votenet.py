"""VoteNet detector (`detection/Votenet/models/votenet.py:25-100`).

Counterpart of ``backtoreality_tpu/models/votenet/votenet.py``:
backbone -> hough voting (+ L2-normalized vote features,
`votenet.py:93-94`) -> proposal module. The backbone computes in `dtype`
(its last `f32_tail` stages in float32), the voting and proposal heads in
`head_dtype`; None is the parameters' dtype, float32. The JAX package's
`build_model` never sets `head_dtype`: its heads stay float32 under bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from backtoreality_tpu_torch.models.votenet.backbone import \
    Pointnet2Backbone
from backtoreality_tpu_torch.models.votenet.proposal import ProposalModule
from backtoreality_tpu_torch.models.votenet.voting import VotingModule


class VoteNet(nn.Module):
    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr,
                 input_feature_dim: int = 0, num_proposal: int = 256,
                 vote_factor: int = 1, sampling: str = "vote_fps",
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None,
                 head_dtype: torch.dtype | None = None, f32_tail: int = 0,
                 backbone: nn.Module | None = None):
        """`backbone` replaces the plain PointNet++ backbone (the
        CenterRefine model's has the jitter head)."""
        super().__init__()
        if backbone is None:
            backbone = Pointnet2Backbone(
                input_feature_dim=input_feature_dim, query_mode=query_mode,
                fps_candidates=fps_candidates, dtype=dtype,
                f32_tail=f32_tail)
        self.backbone_net = backbone
        self.vgen = VotingModule(vote_factor, 256, dtype=head_dtype)
        self.pnet = ProposalModule(
            num_class=num_class, num_heading_bin=num_heading_bin,
            num_size_cluster=num_size_cluster, mean_size_arr=mean_size_arr,
            num_proposal=num_proposal, sampling=sampling,
            query_mode=query_mode, dtype=head_dtype)

    def forward(self, point_clouds, generator=None):
        """point_clouds (B, N, 3+C). Returns the end_points dict.
        `generator`: the draws of ``sampling="random"``."""
        return self.heads(self.backbone_net(point_clouds), generator)

    def heads(self, end_points, generator=None):
        """Voting and proposals on the backbone's end_points."""
        xyz = end_points["fp2_xyz"]
        features = end_points["fp2_features"]
        end_points["seed_inds"] = end_points["fp2_inds"]
        end_points["seed_xyz"] = xyz
        end_points["seed_features"] = features

        xyz, features = self.vgen(xyz, features)
        norm = torch.linalg.vector_norm(features, dim=-1, keepdim=True)
        features = features / torch.clamp(norm, min=1e-12)
        end_points["vote_xyz"] = xyz
        end_points["vote_features"] = features

        return self.pnet(xyz, features, end_points, generator)
