"""VoteNet detector (`detection/Votenet/models/votenet.py:25-100`).

Counterpart of ``backtoreality_tpu/models/votenet/votenet.py``:
backbone -> hough voting (+ L2-normalized vote features,
`votenet.py:93-94`) -> proposal module.
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
                 fps_candidates: int | None = None):
        super().__init__()
        self.backbone_net = Pointnet2Backbone(
            input_feature_dim=input_feature_dim, query_mode=query_mode,
            fps_candidates=fps_candidates)
        self.vgen = VotingModule(vote_factor, 256)
        self.pnet = ProposalModule(
            num_class=num_class, num_heading_bin=num_heading_bin,
            num_size_cluster=num_size_cluster, mean_size_arr=mean_size_arr,
            num_proposal=num_proposal, sampling=sampling,
            query_mode=query_mode)

    def forward(self, point_clouds):
        """point_clouds (B, N, 3+C). Returns the end_points dict."""
        end_points = self.backbone_net(point_clouds)

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

        return self.pnet(xyz, features, end_points)
