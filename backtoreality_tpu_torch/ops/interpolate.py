"""Three-nearest-neighbour feature interpolation.

Counterpart of ``backtoreality_tpu/ops/interpolate.py`` (the reference
CUDA ops `three_nn` / `three_interpolate`, `interpolate_gpu.cu:13-160`):
`three_nn` returns euclidean (sqrt) distances, `three_interpolate` is a
weighted 3-point gather, `interpolation_weights` the FP module's
inverse-distance weights and `three_nn_interpolate` the three in one.
"""

from __future__ import annotations

import torch

from backtoreality_tpu_torch.ops.ball_query import _pairwise_d2


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """For each of n unknown points find its 3 nearest known points.

    Args:
      unknown: (B, n, 3).
      known: (B, m, 3).

    Returns:
      dist: (B, n, 3) euclidean distances (ascending).
      idx: (B, n, 3) int32 indices into m.
    """
    if unknown.dtype == torch.float64:
        # direct form in f64, as the JAX package's x64 path
        diff = unknown[:, :, None, :] - known[:, None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
    else:
        # the expanded form of the JAX f32 path, so neighbour order and
        # near-ties resolve the same way
        d2 = _pairwise_d2(unknown.float(), known.float())  # (B, n, m)
    # a stable sort keeps the lowest index first among ties, as top_k
    d2s, idx = torch.sort(d2, dim=-1, stable=True)
    return (torch.sqrt(torch.clamp(d2s[..., :3], min=0.0)),
            idx[..., :3].to(torch.int32))


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-point feature gather.

    Args:
      features: (B, m, C).
      idx: (B, n, 3) int32 indices into m.
      weight: (B, n, 3) interpolation weights.

    Returns:
      (B, n, C) interpolated features.
    """
    b, n, _ = idx.shape
    c = features.shape[-1]
    index = idx.reshape(b, n * 3, 1).long().expand(-1, -1, c)
    g = torch.gather(features, 1, index).reshape(b, n, 3, c)
    return torch.sum(g * weight[..., None], dim=2)


def interpolation_weights(dist: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights as used by the FP module
    (`pointnet2_modules.py:492-495`): 1 / (dist + eps), normalized over
    the 3 neighbours."""
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def three_nn_interpolate(known_feats: torch.Tensor, known_xyz: torch.Tensor,
                         unknown_xyz: torch.Tensor) -> torch.Tensor:
    """One-shot 3-NN inverse-distance interpolation of `known_feats`
    (B, m, C) at `known_xyz` (B, m, 3) onto `unknown_xyz` (B, n, 3) (GF's
    `ThreeNNInterpolate`, `GroupFree3D/pointnet2/pointnet2_modules.py:
    722-732`)."""
    dist, idx = three_nn(unknown_xyz, known_xyz)
    return three_interpolate(known_feats, idx, interpolation_weights(dist))
