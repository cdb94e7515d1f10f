"""Set-Abstraction and Feature-Propagation modules.

Counterpart of ``backtoreality_tpu/nn/sa_fp.py`` (reference
`pointnet2_modules.py`: PointnetSAModuleMSG :77-126, PointnetSAModuleVotes
:164-272, PointnetSAModuleCenters :357-451, PointnetFPModule :454-514,
PointnetLFPModuleMSG :517-595; GroupFree3D's relative-feature SA),
channels-last (B, N, C):

* FPS and stratified ball query from the op library (CUDA kernels on the
  card);
* grouping -> centre-subtract -> /radius (or /1.0) -> concat xyz (one op,
  `ops.group_localize_stratified`, one kernel on the card) -> SharedMLP ->
  pooling over the neighbourhood.

``query_mode="exact"`` takes the reference's first-k query instead
(`ops.ball_query`) and groups ``[xyz, features]`` with `ops.group_points`,
a gather, before the same subtraction and division
(``backtoreality_tpu/nn/sa_fp.py:22-59``): the mode reference-trained
checkpoints expect.

The options of the JAX modules: ``use_xyz`` (False: the MLP sees the
grouped features alone), ``normalize_xyz`` (the local coordinates divided
by the radius; x / 1.0 == x in IEEE arithmetic, so the fused op at 1.0 is
the un-normalized grouping bit for bit) and ``pooling`` max, avg or rbf
(``sigma``, default radius / 2). The fused op always returns
``[local_xyz, features]``: ``use_xyz=False`` and rbf pooling slice its
output. `SAModuleVotes` normalizes by default (every caller in both
packages sets ``normalize_xyz``; the JAX attribute defaults to False).
`SAModuleMSG`, `SAModuleVotesRlt`, `LFPModuleMSG`, `group_all` and the
`SAModuleOffset` alias are on no recipe's path.

Each module's MLP computes in its `dtype` (None: the parameters'). The
grouping always sees the coordinates' float32: the JAX package
concatenates xyz and the features before it groups them, which promotes
bfloat16 features to float32 (exactly), and so the kernels take float32
on a bfloat16 path too. Submodules carry the JAX names (``mlp``,
``mlp{i}``, ``post_mlp``), so `bridge.state_dict_from_jax` maps them.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from backtoreality_tpu_torch import ops
from backtoreality_tpu_torch.nn.mlp import SharedMLP
from backtoreality_tpu_torch.ops.interpolate import interpolation_weights


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


def _check_pooling(pooling):
    if pooling not in ("max", "avg", "rbf"):
        raise ValueError(f"unknown pooling {pooling!r}")


def _in_width(in_features: int, use_xyz: bool) -> int:
    """The MLP's input width: the grouped features, and the local xyz
    with `use_xyz` or where there are no features."""
    return in_features + (3 if use_xyz or in_features == 0 else 0)


def _grouped(query_mode, xyz, features, centers, radius, nsample, scale,
             use_xyz):
    """(the MLP's input, the local coordinates): `_group`'s output, its
    features alone where `use_xyz` is off and there are features, and its
    first 3 channels (divided by `scale`), which rbf pooling weighs by."""
    both = _group(query_mode, xyz, features, centers, radius, nsample,
                  scale)
    if features is None or use_xyz:
        return both, both[..., :3]
    return both[..., 3:], both[..., :3]


def _pool(new_features, local_xyz, pooling, sigma, nsample):
    """(B, M, S, C) -> (B, M, C): max, mean, or the rbf-weighted sum over
    the slots divided by `nsample` (`pointnet2_modules.py:261-266`), the
    weights exp(-|local_xyz|^2 / sigma^2 / 2) with sigma^2 the Python
    product rounded once, as the JAX package's constant."""
    if pooling == "max":
        return torch.amax(new_features, dim=2)
    if pooling == "avg":
        return torch.mean(new_features, dim=2)
    # tensor divisors: a true division on every device
    s2, n = (torch.full((), v, dtype=local_xyz.dtype,
                        device=local_xyz.device)
             for v in (sigma ** 2, nsample))
    rbf = torch.exp(-torch.sum(torch.square(local_xyz), -1) / s2 / 2)
    return torch.sum(new_features * rbf[..., None], dim=2) / n


class SAModuleVotes(nn.Module):
    """Set abstraction with external-indices support
    (`PointnetSAModuleVotes`, `pointnet2_modules.py:164-272`).

    in_features: width C of the input features (0 for none).
    dtype: the MLP's compute dtype (None: the parameters')."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_features: int, mlp: tp.Sequence[int],
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None, use_xyz: bool = True,
                 normalize_xyz: bool = True, pooling: str = "max",
                 sigma: float | None = None):
        super().__init__()
        _check_query_mode(query_mode)
        _check_pooling(pooling)
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.query_mode = query_mode
        self.fps_candidates = fps_candidates
        self.use_xyz = use_xyz
        self.scale = radius if normalize_xyz else 1.0
        self.pooling = pooling
        self.sigma = radius / 2 if sigma is None else sigma
        self.mlp = SharedMLP(_in_width(in_features, use_xyz), mlp,
                             dtype=dtype)

    def forward(self, xyz, features=None, inds=None):
        """xyz (B,N,3); features (B,N,C) or None; inds optional (B,npoint).

        Returns (new_xyz (B,npoint,3), new_features (B,npoint,mlp[-1]),
        inds (B,npoint))."""
        if inds is None:
            inds = ops.furthest_point_sample(
                xyz, self.npoint, candidates=self.fps_candidates)
        new_xyz = ops.gather_points(xyz, inds)
        grouped, local_xyz = _grouped(
            self.query_mode, xyz, features, new_xyz, self.radius,
            self.nsample, self.scale, self.use_xyz)
        return new_xyz, _pool(self.mlp(grouped), local_xyz, self.pooling,
                              self.sigma, self.nsample), inds


class SAModuleCenters(nn.Module):
    """Set abstraction around *given* centres — the jitter head
    (`PointnetSAModuleCenters`, `pointnet2_modules.py:357-451`).

    The grouping divides the local coordinates by the radius when
    `normalize_xyz` is set (GroupFree3D's head) and by 1.0 otherwise
    (VoteNet's)."""

    def __init__(self, radius: float, nsample: int, in_features: int,
                 mlp: tp.Sequence[int], query_mode: str = "stratified",
                 normalize_xyz: bool = False,
                 dtype: torch.dtype | None = None, use_xyz: bool = True,
                 pooling: str = "max", sigma: float | None = None):
        super().__init__()
        _check_query_mode(query_mode)
        _check_pooling(pooling)
        self.radius = radius
        self.nsample = nsample
        self.query_mode = query_mode
        self.scale = radius if normalize_xyz else 1.0
        self.use_xyz = use_xyz
        self.pooling = pooling
        self.sigma = radius / 2 if sigma is None else sigma
        self.mlp = SharedMLP(_in_width(in_features, use_xyz), mlp,
                             dtype=dtype)

    def forward(self, xyz, features, centers):
        """xyz (B,N,3); features (B,N,C); centers (B,M,3). Returns
        (B, M, mlp[-1]) features grouped at the centres."""
        grouped, local_xyz = _grouped(
            self.query_mode, xyz, features, centers, self.radius,
            self.nsample, self.scale, self.use_xyz)
        return _pool(self.mlp(grouped), local_xyz, self.pooling, self.sigma,
                     self.nsample)


# `PointnetSAModuleOffset` (GF `pointnet2_modules.py:481-578`, unused by
# the four train paths) is set abstraction grouped at caller-supplied
# centres with max/avg/rbf pooling and no FPS: SAModuleCenters' contract,
# so it is the same module here, as in the JAX package.
SAModuleOffset = SAModuleCenters


def group_all(xyz, features, use_xyz: bool = True):
    """`GroupAll` (`pointnet2_utils.py:379-427`): the whole cloud as one
    region, coordinates not centred. Returns (grouped (B, 1, N, C[+3]),
    grouped_xyz (B, 1, N, 3))."""
    grouped_xyz = xyz[:, None, :, :]
    if features is None:
        return grouped_xyz, grouped_xyz
    grouped = _as_xyz_dtype(features, xyz)[:, None, :, :]
    if use_xyz:
        grouped = torch.cat([grouped_xyz, grouped], -1)
    return grouped, grouped_xyz


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (`PointnetSAModuleMSG`,
    `pointnet2_modules.py:77-126`; also `PointnetSAModuleMSGVotes`
    :275-354): one FPS, then per (radius, nsample, mlp) branch a grouping
    (divided by the branch's radius with `normalize_xyz`), its MLP
    ``mlp{i}`` and max pooling; the branches' features concatenated.
    npoint=None groups the whole cloud in every branch (`group_all`) and
    returns no centres."""

    def __init__(self, npoint: int | None, radii: tp.Sequence[float],
                 nsamples: tp.Sequence[int], in_features: int,
                 mlps: tp.Sequence[tp.Sequence[int]], use_xyz: bool = True,
                 normalize_xyz: bool = False,
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps must have one entry"
                             " per branch")
        _check_query_mode(query_mode)
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.query_mode = query_mode
        self.fps_candidates = fps_candidates
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP(
                _in_width(in_features, use_xyz), mlp, dtype=dtype))

    def forward(self, xyz, features=None, inds=None):
        """xyz (B,N,3); features (B,N,C) or None; inds optional (B,npoint).
        Returns (new_xyz (B,npoint,3) or None, (B, npoint or 1,
        sum of mlps[i][-1]), inds)."""
        new_xyz = None
        if self.npoint is not None:
            if inds is None:
                inds = ops.furthest_point_sample(
                    xyz, self.npoint, candidates=self.fps_candidates)
            new_xyz = ops.gather_points(xyz, inds)
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii,
                                                  self.nsamples)):
            if new_xyz is None:
                grouped, _ = group_all(xyz, features, self.use_xyz)
            else:
                grouped, _ = _grouped(
                    self.query_mode, xyz, features, new_xyz, radius,
                    nsample, radius if self.normalize_xyz else 1.0,
                    self.use_xyz)
            outs.append(torch.amax(getattr(self, f"mlp{i}")(grouped),
                                   dim=2))
        return new_xyz, torch.cat(outs, dim=-1), inds


class SAModuleVotesRlt(nn.Module):
    """Relative-feature set abstraction (GF `pointnet2_modules.py:
    274-383`, dead in the reference: its grouper was never committed; the
    JAX package realizes the channel contract ``3 + 2C`` of :316-318).
    Each slot carries its local xyz, its feature and its feature minus the
    sampled centre's own feature (gathered from the ungrouped features at
    the FPS indices), so the MLP's input width is 3 + 2C (2C without
    `use_xyz`)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_features: int, mlp: tp.Sequence[int],
                 use_xyz: bool = True, normalize_xyz: bool = False,
                 pooling: str = "max", sigma: float | None = None,
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        _check_query_mode(query_mode)
        _check_pooling(pooling)
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.use_xyz = use_xyz
        self.scale = radius if normalize_xyz else 1.0
        self.pooling = pooling
        self.sigma = radius / 2 if sigma is None else sigma
        self.query_mode = query_mode
        self.fps_candidates = fps_candidates
        self.mlp = SharedMLP((3 if use_xyz else 0) + 2 * in_features, mlp,
                             dtype=dtype)

    def forward(self, xyz, features, inds=None):
        """xyz (B,N,3); features (B,N,C); inds optional (B,npoint).
        Returns (new_xyz, new_features (B,npoint,mlp[-1]), inds)."""
        if inds is None:
            inds = ops.furthest_point_sample(
                xyz, self.npoint, candidates=self.fps_candidates)
        new_xyz = ops.gather_points(xyz, inds)
        both = _group(self.query_mode, xyz, features, new_xyz, self.radius,
                      self.nsample, self.scale)
        local_xyz, feats = both[..., :3], both[..., 3:]
        centre_feats = ops.gather_points(features, inds)  # (B, npoint, C)
        rel = feats - centre_feats[:, :, None, :]
        parts = [local_xyz, feats, rel] if self.use_xyz else [feats, rel]
        new_features = self.mlp(torch.cat(parts, -1))
        return new_xyz, _pool(new_features, local_xyz, self.pooling,
                              self.sigma, self.nsample), inds


class LFPModuleMSG(nn.Module):
    """Learnable multi-scale feature propagation (`PointnetLFPModuleMSG`,
    `pointnet2_modules.py:517-595`): per (radius, nsample, mlp) scale,
    `features1` at `xyz1` ball-query-grouped around the `xyz2` positions
    (no radius normalization), its MLP ``mlp{i}`` and max pooling, the
    `features2` skip concatenated, then ``post_mlp``, ONE module shared by
    every scale and called once per scale (in train mode its BN running
    statistics move once a scale, the second move starting from the
    first, as the JAX package's); the scales' outputs concatenated.

    in_features1, in_features2: the widths of `features1` and of the skip
    `features2` (0 for none). Every scale's MLP ends at one width, the
    shared post-MLP's input with the skip."""

    def __init__(self, radii: tp.Sequence[float], nsamples: tp.Sequence[int],
                 in_features1: int, in_features2: int,
                 mlps: tp.Sequence[tp.Sequence[int]],
                 post_mlp: tp.Sequence[int], use_xyz: bool = True,
                 query_mode: str = "stratified",
                 dtype: torch.dtype | None = None):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps must have one entry"
                             " per scale")
        if len({mlp[-1] for mlp in mlps}) != 1:
            raise ValueError("the post-MLP is shared: every scale's MLP must"
                             " end at one width")
        _check_query_mode(query_mode)
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        self.query_mode = query_mode
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP(
                _in_width(in_features1, use_xyz), mlp, dtype=dtype))
        self.post_mlp = SharedMLP(mlps[0][-1] + in_features2, post_mlp,
                                  dtype=dtype)

    def forward(self, xyz2, xyz1, features2, features1):
        """xyz2 (B,N2,3) targets; xyz1 (B,N1,3) sources; features2
        (B,N2,C2) skip or None; features1 (B,N1,C1).
        Returns (B, N2, len(radii) * post_mlp[-1])."""
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii,
                                                  self.nsamples)):
            grouped, _ = _grouped(self.query_mode, xyz1, features1, xyz2,
                                  radius, nsample, 1.0, self.use_xyz)
            feat = torch.amax(getattr(self, f"mlp{i}")(grouped), dim=2)
            if features2 is not None:
                feat = torch.cat([feat, features2], -1)
            # one slot a target, as the JAX package calls it
            outs.append(self.post_mlp(feat[:, :, None, :])[:, :, 0, :])
        return torch.cat(outs, dim=-1)


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
        interp = ops.three_interpolate(known_feats, idx,
                                       interpolation_weights(dist))
        if unknown_feats is not None:
            feats = torch.cat([interp, unknown_feats], dim=-1)
        else:
            feats = interp
        return self.mlp(feats)
