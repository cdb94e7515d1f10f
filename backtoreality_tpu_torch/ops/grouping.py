"""Index gathers for point sets.

Counterpart of ``backtoreality_tpu/ops/grouping.py``: the reference CUDA
ops `gather_points` / `group_points` (`sampling_gpu.cu:13-62`,
`group_points_gpu.cu:13-86`) as plain ``torch.gather``, channels-last
(B, N, C). Autograd's transpose of a gather is the scatter-add backward.
"""

from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (B, N, C) by (B, M) -> (B, M, C)."""
    c = points.shape[-1]
    index = idx.long()[..., None].expand(-1, -1, c)
    return torch.gather(points, 1, index)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (B, N, C) by (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    flat = gather_points(points, idx.reshape(b, m * s))
    return flat.reshape(b, m, s, points.shape[-1])


def group_points_stratified(points: torch.Tensor, idx: torch.Tensor,
                            hit: torch.Tensor) -> torch.Tensor:
    """`group_points` for stratified ball-query output.

    The JAX package replaces the gather with one-hot contractions and
    repairs slot-filled entries from the first-hit slot afterwards; the
    result equals ``group_points(points, idx)``, which is what this
    returns. `hit` is accepted for the same signature.
    """
    del hit  # idx is already slot-filled
    return group_points(points, idx)
