"""Proposal module: vote clustering + box-parameter head.

Counterpart of ``backtoreality_tpu/models/votenet/proposal.py``
(reference `proposal_module.py:18-120`): an SA layer clusters votes
around `num_proposal` centres sampled by FPS on the votes (``vote_fps``),
by FPS on the seeds (``seed_fps``) or uniformly over the seeds
(``random``: drawn from a ``torch.Generator`` the caller passes, or given
as `sample_inds`); a pointwise head emits
2 objectness + 3 centre-offset + 2*NH heading + 4*NS size + num_class
semantic logits, decoded into the end_points dict in f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from backtoreality_tpu_torch import ops
from backtoreality_tpu_torch.nn import PointwiseMLP, SAModuleVotes


def decode_scores(net, end_points, num_class, num_heading_bin,
                  num_size_cluster, mean_size_arr):
    """`proposal_module.py:18-50`. net: (B, K, 2+3+NH*2+NS*4+num_class);
    mean_size_arr: (NS, 3) tensor of net's dtype and device."""
    nh, ns = num_heading_bin, num_size_cluster
    end_points["objectness_scores"] = net[..., 0:2]

    base_xyz = end_points["aggregated_vote_xyz"]  # (B, K, 3)
    end_points["center"] = base_xyz + net[..., 2:5]

    heading_residuals_normalized = net[..., 5 + nh:5 + nh * 2]
    end_points["heading_scores"] = net[..., 5:5 + nh]
    end_points["heading_residuals_normalized"] = (
        heading_residuals_normalized)
    end_points["heading_residuals"] = (
        heading_residuals_normalized * (math.pi / nh))

    b, k = net.shape[0], net.shape[1]
    size_scores = net[..., 5 + nh * 2:5 + nh * 2 + ns]
    size_residuals_normalized = net[
        ..., 5 + nh * 2 + ns:5 + nh * 2 + ns * 4
    ].reshape(b, k, ns, 3)
    end_points["size_scores"] = size_scores
    end_points["size_residuals_normalized"] = size_residuals_normalized
    msa = mean_size_arr[None, None]  # (1, 1, NS, 3)
    end_points["size_residuals"] = size_residuals_normalized * msa
    size_recover = msa + end_points["size_residuals"]
    pred_size_class = torch.argmax(size_scores, -1)  # (B, K)
    index = pred_size_class[..., None, None].expand(-1, -1, 1, 3)
    end_points["pred_size"] = torch.gather(size_recover, 2, index)[:, :, 0]

    end_points["sem_cls_scores"] = net[..., 5 + nh * 2 + ns * 4:]
    return end_points


class ProposalModule(PointwiseMLP):
    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr,
                 num_proposal: int = 256, sampling: str = "vote_fps",
                 seed_feat_dim: int = 256, query_mode: str = "stratified",
                 dtype: torch.dtype | None = None):
        out_dim = (2 + 3 + num_heading_bin * 2 + num_size_cluster * 4
                   + num_class)
        # no bias before BN (see voting.py)
        super().__init__(128, [128, 128], out_dim, dtype=dtype)
        if sampling not in ("vote_fps", "seed_fps", "random"):
            raise ValueError(f"unknown sampling {sampling!r}")
        self.num_proposal = num_proposal
        self.sampling = sampling
        self.num_class = num_class
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        self.mean_size_arr = np.asarray(mean_size_arr, np.float64)
        self.vote_aggregation = SAModuleVotes(
            npoint=num_proposal, radius=0.3, nsample=16,
            in_features=seed_feat_dim, mlp=[128, 128, 128],
            query_mode=query_mode, dtype=dtype)

    def forward(self, xyz, features, end_points, generator=None,
                sample_inds=None):
        """xyz: vote positions (B, num_vote, 3); features (B, num_vote, C).

        ``random`` sampling draws (B, num_proposal) seed indices, uniform
        over the seeds, from `generator` (a ``torch.Generator`` on the
        votes' device; the global one is never read), unless `sample_inds`
        (B, num_proposal) gives them."""
        if sample_inds is not None and self.sampling != "random":
            raise ValueError(f"sampling {self.sampling!r} takes no"
                             " sample_inds")
        if self.sampling == "vote_fps":
            new_xyz, new_features, sample_inds = self.vote_aggregation(
                xyz, features)
        else:
            if self.sampling == "seed_fps":
                sample_inds = ops.furthest_point_sample(
                    end_points["seed_xyz"], self.num_proposal)
            elif sample_inds is None:
                if not isinstance(generator, torch.Generator):
                    raise TypeError("random sampling draws from a"
                                    " torch.Generator the caller passes")
                sample_inds = torch.randint(
                    0, end_points["seed_xyz"].shape[1],
                    (xyz.shape[0], self.num_proposal), generator=generator,
                    device=xyz.device, dtype=torch.int32)
            new_xyz, new_features, _ = self.vote_aggregation(
                xyz, features, sample_inds)
        end_points["aggregated_vote_xyz"] = new_xyz
        end_points["aggregated_vote_features"] = new_features
        end_points["aggregated_vote_inds"] = sample_inds

        net = super().forward(new_features)
        # decode in f32 (or f64 under the x64 parity tests)
        dt = torch.float64 if net.dtype == torch.float64 else torch.float32
        # non_blocking: a host constant needs no stream sync
        msa = torch.as_tensor(self.mean_size_arr, dtype=dt).to(
            net.device, non_blocking=True)
        return decode_scores(net.to(dt), end_points, self.num_class,
                             self.num_heading_bin, self.num_size_cluster,
                             msa)
