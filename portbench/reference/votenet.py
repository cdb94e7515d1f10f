"""Plain VoteNet (Qi et al., ICCV 2019): the PointNet++ backbone, Hough
voting (votes = seeds + offsets, vote features L2-normalised), proposals
clustered by FPS on the votes, and the box head decoded to the
end-points the loss and the box parser read."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from portbench.reference.nn import Backbone, PointwiseMLP, SAModuleVotes


class VotingModule(PointwiseMLP):
    def __init__(self, c: int = 256):
        super().__init__(c, [c, c], 3 + c)
        self.c = c

    def forward(self, seed_xyz, seed_features):
        b, n, _ = seed_xyz.shape
        net = super().forward(seed_features).reshape(b, n, 1, 3 + self.c)
        vote_xyz = (seed_xyz[:, :, None, :] + net[..., 0:3]).reshape(b, n, 3)
        vote_features = (seed_features[:, :, None, :]
                         + net[..., 3:]).reshape(b, n, self.c)
        return vote_xyz, vote_features


class ProposalModule(PointwiseMLP):
    def __init__(self, num_class, num_heading_bin, num_size_cluster,
                 mean_size_arr, num_proposal):
        super().__init__(128, [128, 128], 2 + 3 + num_heading_bin * 2
                         + num_size_cluster * 4 + num_class)
        self.nh, self.ns = num_heading_bin, num_size_cluster
        self.mean_size_arr = np.asarray(mean_size_arr, np.float64)
        self.vote_aggregation = SAModuleVotes(num_proposal, 0.3, 16, 256,
                                              [128, 128, 128])

    def forward(self, xyz, features, ep):
        new_xyz, new_features, inds = self.vote_aggregation(xyz, features)
        ep["aggregated_vote_xyz"] = new_xyz
        ep["aggregated_vote_inds"] = inds
        net = super().forward(new_features)
        nh, ns = self.nh, self.ns
        msa = torch.as_tensor(self.mean_size_arr, dtype=torch.float32).to(
            net.device)[None, None]
        b, k = net.shape[:2]
        ep["objectness_scores"] = net[..., 0:2]
        ep["center"] = new_xyz + net[..., 2:5]
        ep["heading_scores"] = net[..., 5:5 + nh]
        hrn = net[..., 5 + nh:5 + nh * 2]
        ep["heading_residuals_normalized"] = hrn
        ep["heading_residuals"] = hrn * (math.pi / nh)
        size_scores = net[..., 5 + nh * 2:5 + nh * 2 + ns]
        srn = net[..., 5 + nh * 2 + ns:5 + nh * 2 + ns * 4].reshape(
            b, k, ns, 3)
        ep["size_scores"] = size_scores
        ep["size_residuals_normalized"] = srn
        ep["size_residuals"] = srn * msa
        ep["sem_cls_scores"] = net[..., 5 + nh * 2 + ns * 4:]
        return ep


class VoteNet(nn.Module):
    def __init__(self, num_class, num_heading_bin, num_size_cluster,
                 mean_size_arr, input_feature_dim, num_proposal):
        super().__init__()
        self.backbone_net = Backbone(input_feature_dim)
        self.vgen = VotingModule(256)
        self.pnet = ProposalModule(num_class, num_heading_bin,
                                   num_size_cluster, mean_size_arr,
                                   num_proposal)

    def forward(self, point_clouds):
        ep = self.backbone_net(point_clouds)
        ep["seed_inds"] = ep["fp2_inds"]
        ep["seed_xyz"] = ep["fp2_xyz"]
        xyz, features = self.vgen(ep["fp2_xyz"], ep["fp2_features"])
        norm = torch.linalg.vector_norm(features, dim=-1, keepdim=True)
        features = features / torch.clamp(norm, min=1e-12)
        ep["vote_xyz"] = xyz
        return self.pnet(xyz, features, ep)


def build(config) -> VoteNet:
    m = config["model"]
    return VoteNet(m["num_class"], m["num_heading_bin"],
                   m["num_size_cluster"], config["mean_size_arr"],
                   m["input_feature_dim"], m["num_proposal"])
