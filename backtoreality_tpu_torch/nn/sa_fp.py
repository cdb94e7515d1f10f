"""Set-Abstraction and Feature-Propagation modules.

Counterpart of ``backtoreality_tpu/nn/sa_fp.py`` (reference
`pointnet2_modules.py`: PointnetSAModuleVotes :164-272, PointnetFPModule
:454-514), channels-last (B, N, C):

* FPS and stratified ball query from the op library (CUDA kernels on the
  card);
* grouping -> centre-subtract -> /radius -> concat xyz -> SharedMLP ->
  max-pool over the neighbourhood.

Only what VoteNet runs is ported: the stratified query, radius-normalized
xyz concatenated to the features, and max pooling.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from backtoreality_tpu_torch import ops
from backtoreality_tpu_torch.nn.mlp import SharedMLP


class SAModuleVotes(nn.Module):
    """Set abstraction with external-indices support
    (`PointnetSAModuleVotes`, `pointnet2_modules.py:164-272`, with
    use_xyz and normalize_xyz on, max pooling).

    in_features: width C of the input features (0 for none)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_features: int, mlp: tp.Sequence[int],
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None):
        super().__init__()
        if query_mode != "stratified":
            raise NotImplementedError(
                f"query_mode {query_mode!r} is not ported")
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.fps_candidates = fps_candidates
        self.mlp = SharedMLP(3 + in_features, mlp)

    def _group(self, xyz, new_xyz, features):
        """Ball-query + group + localize: (B, npoint, nsample, 3[+C])."""
        idx, hit = ops.ball_query_stratified(
            xyz, new_xyz, self.radius, self.nsample, return_hit=True)
        points = xyz if features is None else torch.cat([xyz, features], -1)
        grouped = ops.group_points_stratified(points, idx, hit)
        local_xyz = (grouped[..., :3] - new_xyz[:, :, None, :]) / self.radius
        return torch.cat([local_xyz, grouped[..., 3:]], -1)

    def forward(self, xyz, features=None, inds=None):
        """xyz (B,N,3); features (B,N,C) or None; inds optional (B,npoint).

        Returns (new_xyz (B,npoint,3), new_features (B,npoint,mlp[-1]),
        inds (B,npoint))."""
        if inds is None:
            inds = ops.furthest_point_sample(
                xyz, self.npoint, candidates=self.fps_candidates)
        new_xyz = ops.gather_points(xyz, inds)
        new_features = self.mlp(self._group(xyz, new_xyz, features))
        return new_xyz, torch.amax(new_features, dim=2), inds


class FPModule(nn.Module):
    """Feature propagation (`PointnetFPModule`,
    `pointnet2_modules.py:454-514`): 3-NN inverse-distance interpolation
    of `known` features onto `unknown` positions, concat skip features,
    SharedMLP. in_features: interpolated plus skip width."""

    def __init__(self, in_features: int, mlp: tp.Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp)

    def forward(self, unknown, known, unknown_feats, known_feats):
        """unknown (B,n,3); known (B,m,3); unknown_feats (B,n,C1) or None;
        known_feats (B,m,C2). Returns (B,n,mlp[-1])."""
        dist, idx = ops.three_nn(unknown, known)
        weight = 1.0 / (dist + 1e-8)
        weight = weight / torch.sum(weight, dim=-1, keepdim=True)
        interp = ops.three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            feats = torch.cat([interp, unknown_feats], dim=-1)
        else:
            feats = interp
        return self.mlp(feats)
