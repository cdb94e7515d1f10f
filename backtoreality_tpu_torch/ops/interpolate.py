"""Three-nearest-neighbour feature interpolation.

Counterpart of ``backtoreality_tpu/ops/interpolate.py`` (the reference
CUDA ops `three_nn` / `three_interpolate`, `interpolate_gpu.cu:13-160`):
`three_nn` returns euclidean (sqrt) distances, and `three_interpolate`
is a weighted 3-point gather.
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
