"""Hough voting module (`detection/Votenet/models/voting_module.py:16-65`).

Counterpart of ``backtoreality_tpu/models/votenet/voting.py``: a per-seed
head predicting `vote_factor` (xyz offset, residual feature) pairs;
votes = seed + offset, vote features = seed features + residual.
"""

from __future__ import annotations

from backtoreality_tpu_torch.nn import PointwiseMLP


class VotingModule(PointwiseMLP):
    def __init__(self, vote_factor: int = 1, seed_feature_dim: int = 256):
        c = seed_feature_dim
        # no bias before BN: the JAX package folds the reference's
        # pre-BN conv bias into the BN running mean
        super().__init__(c, [c, c], (3 + c) * vote_factor)
        self.vote_factor = vote_factor
        self.seed_feature_dim = c

    def forward(self, seed_xyz, seed_features):
        """seed_xyz (B, num_seed, 3); seed_features (B, num_seed, C).

        Returns vote_xyz (B, num_seed*vote_factor, 3) and vote_features
        (B, num_seed*vote_factor, C)."""
        b, num_seed, _ = seed_xyz.shape
        c, vf = self.seed_feature_dim, self.vote_factor
        net = super().forward(seed_features).reshape(b, num_seed, vf, 3 + c)
        vote_xyz = (seed_xyz[:, :, None, :] + net[..., 0:3]).reshape(
            b, num_seed * vf, 3)
        vote_features = (seed_features[:, :, None, :]
                         + net[..., 3:]).reshape(b, num_seed * vf, c)
        return vote_xyz, vote_features
