"""BoxNet — the VoteNet-without-voting ablation
(`detection/Votenet/models/boxnet.py:20-115`).

Counterpart of ``backtoreality_tpu/models/votenet/boxnet.py``: the
backbone's seeds feed the proposal module directly (no Hough voting
stage), so vote clustering groups the seeds' FP2 features. Paired with
`losses.votenet.get_loss_boxnet`. Submodules carry the JAX names
(``backbone_net``, ``pnet``), both computing in `dtype`.
"""

from __future__ import annotations

import torch
from torch import nn

from backtoreality_tpu_torch.models.votenet.backbone import \
    Pointnet2Backbone
from backtoreality_tpu_torch.models.votenet.proposal import ProposalModule
from backtoreality_tpu_torch.train.observability import span


class BoxNet(nn.Module):
    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr,
                 input_feature_dim: int = 0, num_proposal: int = 256,
                 sampling: str = "vote_fps", query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.backbone_net = Pointnet2Backbone(
            input_feature_dim=input_feature_dim, query_mode=query_mode,
            fps_candidates=fps_candidates, dtype=dtype)
        self.pnet = ProposalModule(
            num_class=num_class, num_heading_bin=num_heading_bin,
            num_size_cluster=num_size_cluster, mean_size_arr=mean_size_arr,
            num_proposal=num_proposal, sampling=sampling,
            query_mode=query_mode, dtype=dtype)

    def forward(self, point_clouds, generator=None):
        """point_clouds (B, N, 3+C). Returns the end_points dict (no
        ``vote_*`` entries). `generator`: the draws of
        ``sampling="random"``."""
        with span("model"):
            end_points = self.backbone_net(point_clouds)
            xyz = end_points["fp2_xyz"]
            features = end_points["fp2_features"]
            end_points["seed_inds"] = end_points["fp2_inds"]
            end_points["seed_xyz"] = xyz
            end_points["seed_features"] = features
            # the proposals straight from the seeds
            with span("model.proposal"):
                return self.pnet(xyz, features, end_points, generator)
