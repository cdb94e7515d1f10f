"""Set-Abstraction and Feature-Propagation modules.

Counterpart of ``backtoreality_tpu/nn/sa_fp.py`` (reference
`pointnet2_modules.py`: PointnetSAModuleVotes :164-272,
PointnetSAModuleCenters :357-451, PointnetFPModule :454-514),
channels-last (B, N, C):

* FPS and stratified ball query from the op library (CUDA kernels on the
  card);
* grouping -> centre-subtract -> /radius -> concat xyz (one op,
  `ops.group_localize_stratified`, one kernel on the card) -> SharedMLP ->
  max-pool over the neighbourhood.

``query_mode="exact"`` takes the reference's first-k query instead
(`ops.ball_query`) and groups ``[xyz, features]`` with `ops.group_points`,
a gather, before the same subtraction and division
(``backtoreality_tpu/nn/sa_fp.py:22-59``): the mode reference-trained
checkpoints expect.

Only what the ported models run is ported: the stratified and the exact
query, xyz concatenated to the features (radius-normalized in
`SAModuleVotes`; in `SAModuleCenters` when `normalize_xyz` is set, as
GroupFree3D's jitter head sets it), and max pooling.

Each module's MLP computes in its `dtype` (None: the parameters'). The
grouping always sees the coordinates' float32: the JAX package
concatenates xyz and the features before it groups them, which promotes
bfloat16 features to float32 (exactly), and so the kernels take float32
on a bfloat16 path too.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from backtoreality_tpu_torch import ops
from backtoreality_tpu_torch.nn.mlp import SharedMLP


def _as_xyz_dtype(features, xyz):
    """`features` promoted to the coordinates' dtype (bfloat16 to float32),
    as the JAX package's concatenation of the two does."""
    if features is None:
        return None
    return features.to(torch.promote_types(features.dtype, xyz.dtype))


def _check_query_mode(query_mode):
    if query_mode not in ("stratified", "exact"):
        raise ValueError(f"unknown query_mode {query_mode!r}")


def _group(query_mode, xyz, features, centers, radius, nsample, scale):
    """Ball query + group + localize at `centers`: (B, M, nsample, 3[+C]),
    the local coordinates divided by `scale`. Stratified: the fused op
    (one kernel on the card). Exact: the first-k query, a gather of
    ``[xyz, features]``, the centre subtracted, then the division."""
    features = _as_xyz_dtype(features, xyz)
    if query_mode == "stratified":
        idx, hit = ops.ball_query_stratified(xyz, centers, radius, nsample,
                                             return_hit=True)
        return ops.group_localize_stratified(xyz, features, centers, idx,
                                             hit, scale)
    idx = ops.ball_query(xyz, centers, radius, nsample)
    points = xyz if features is None else torch.cat([xyz, features], -1)
    grouped = ops.group_points(points, idx)
    # a tensor divisor: a true division on every device, as the fused op's
    r = torch.full((), scale, dtype=xyz.dtype, device=xyz.device)
    local_xyz = (grouped[..., :3] - centers[:, :, None, :]) / r
    if features is None:
        return local_xyz
    return torch.cat([local_xyz, grouped[..., 3:]], -1)


class SAModuleVotes(nn.Module):
    """Set abstraction with external-indices support
    (`PointnetSAModuleVotes`, `pointnet2_modules.py:164-272`, with
    use_xyz and normalize_xyz on, max pooling).

    in_features: width C of the input features (0 for none).
    dtype: the MLP's compute dtype (None: the parameters')."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_features: int, mlp: tp.Sequence[int],
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        _check_query_mode(query_mode)
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.query_mode = query_mode
        self.fps_candidates = fps_candidates
        self.mlp = SharedMLP(3 + in_features, mlp, dtype=dtype)

    def forward(self, xyz, features=None, inds=None):
        """xyz (B,N,3); features (B,N,C) or None; inds optional (B,npoint).

        Returns (new_xyz (B,npoint,3), new_features (B,npoint,mlp[-1]),
        inds (B,npoint))."""
        if inds is None:
            inds = ops.furthest_point_sample(
                xyz, self.npoint, candidates=self.fps_candidates)
        new_xyz = ops.gather_points(xyz, inds)
        new_features = self.mlp(_group(self.query_mode, xyz, features,
                                       new_xyz, self.radius, self.nsample,
                                       self.radius))
        return new_xyz, torch.amax(new_features, dim=2), inds


class SAModuleCenters(nn.Module):
    """Set abstraction around *given* centres — the jitter head
    (`PointnetSAModuleCenters`, `pointnet2_modules.py:357-451`, with
    use_xyz on and max pooling).

    The grouping divides the local coordinates by the radius when
    `normalize_xyz` is set (GroupFree3D's head) and by 1.0 otherwise
    (VoteNet's): x / 1.0 == x in IEEE arithmetic, so that gives the
    un-normalized grouping bit for bit."""

    def __init__(self, radius: float, nsample: int, in_features: int,
                 mlp: tp.Sequence[int], query_mode: str = "stratified",
                 normalize_xyz: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        _check_query_mode(query_mode)
        self.radius = radius
        self.nsample = nsample
        self.query_mode = query_mode
        self.scale = radius if normalize_xyz else 1.0
        self.mlp = SharedMLP(3 + in_features, mlp, dtype=dtype)

    def forward(self, xyz, features, centers):
        """xyz (B,N,3); features (B,N,C); centers (B,M,3). Returns
        (B, M, mlp[-1]) features grouped at the centres."""
        grouped = _group(self.query_mode, xyz, features, centers,
                         self.radius, self.nsample, self.scale)
        return torch.amax(self.mlp(grouped), dim=2)


class FPModule(nn.Module):
    """Feature propagation (`PointnetFPModule`,
    `pointnet2_modules.py:454-514`): 3-NN inverse-distance interpolation
    of `known` features onto `unknown` positions, concat skip features,
    SharedMLP. in_features: interpolated plus skip width. The
    interpolation's float32 weights promote bfloat16 features to float32,
    and so does the concatenation, as in the JAX package; the MLP then
    computes in `dtype`."""

    def __init__(self, in_features: int, mlp: tp.Sequence[int],
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp, dtype=dtype)

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
