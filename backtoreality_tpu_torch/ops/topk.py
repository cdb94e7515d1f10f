"""Top-k selection in XLA's order among ties."""

from __future__ import annotations

import torch


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the `k` largest entries of each row of `scores`,
    largest first and, among equal values, the lower index first (what
    XLA's top-k returns; ``torch.topk`` promises no order among ties)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][
        ..., :k]
