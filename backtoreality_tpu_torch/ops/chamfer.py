"""Chamfer / nearest-neighbour distance between point sets.

Counterpart of ``backtoreality_tpu/ops/chamfer.py`` (reference
`detection/Votenet/utils/nn_distance.py:15-61`, used by the loss stack):
a dense (B, N, M) broadcast in plain PyTorch. The sets are small (votes,
proposals, GT boxes), so no kernel is needed.
"""

from __future__ import annotations

import torch


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Smooth-L1 (`utils/nn_distance.py:15-32`): quadratic within delta,
    linear outside. Elementwise."""
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic**2 + delta * linear


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor,
                l1smooth: bool = False, l1: bool = False,
                delta: float = 1.0):
    """Bidirectional nearest-neighbour distance.

    Args:
      pc1: (B, N, C) points.
      pc2: (B, M, C) points.
      l1smooth: use the huber distance per coordinate.
      l1: use |.| per coordinate (otherwise the squared distance).

    Returns:
      dist1 (B, N), idx1 (B, N) int32, dist2 (B, M), idx2 (B, M) int32:
      each point's distance to its nearest neighbour in the other set and
      that neighbour's index (ties to the lowest index).
    """
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]  # (B, N, M, C)
    if l1smooth:
        pc_dist = torch.sum(huber_loss(diff, delta), dim=-1)
    elif l1:
        pc_dist = torch.sum(torch.abs(diff), dim=-1)
    else:
        pc_dist = torch.sum(diff * diff, dim=-1)
    dist1 = torch.amin(pc_dist, dim=2)
    idx1 = torch.argmin(pc_dist, dim=2).to(torch.int32)
    dist2 = torch.amin(pc_dist, dim=1)
    idx2 = torch.argmin(pc_dist, dim=1).to(torch.int32)
    return dist1, idx1, dist2, idx2
