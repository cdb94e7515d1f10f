"""Shared (pointwise) MLP stacks.

Counterpart of ``backtoreality_tpu/nn/mlp.py``. Channels-last, a 1x1
conv is a Linear layer on the trailing axis. Submodules are named as in
the JAX package (``dense{i}``, ``bn{i}``, ``out``) so that weights map
across mechanically (see ``bridge.py``).
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from backtoreality_tpu_torch.nn.norm import BatchNorm


class SharedMLP(nn.Module):
    """(Linear without bias + BN + ReLU) per width, applied pointwise over
    the trailing axis (the reference SharedMLP activates every layer).

    in_features: input width.
    channels: output width per layer.
    """

    def __init__(self, in_features: int, channels: tp.Sequence[int]):
        super().__init__()
        self.num = len(channels)
        width = in_features
        for i, ch in enumerate(channels):
            dense = nn.Linear(width, ch, bias=False)
            # kaiming-normal init (`pytorch_utils.py:96-98`), as the JAX
            # package's he_normal
            nn.init.kaiming_normal_(dense.weight, nonlinearity="relu")
            self.add_module(f"dense{i}", dense)
            self.add_module(f"bn{i}", BatchNorm(ch))
            width = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num):
            x = getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x))
            x = torch.relu(x)
        return x


class PointwiseMLP(nn.Module):
    """Conv1d-style prediction head: (Linear without bias + BN + ReLU) per
    hidden width, then a biased Linear ``out``
    (`voting_module.py:33-37`, `proposal_module.py:80-85`). PyTorch's
    default Linear init is the reference's head init."""

    def __init__(self, in_features: int, hidden: tp.Sequence[int],
                 out: int):
        super().__init__()
        self.num = len(hidden)
        width = in_features
        for i, ch in enumerate(hidden):
            self.add_module(f"dense{i}", nn.Linear(width, ch, bias=False))
            self.add_module(f"bn{i}", BatchNorm(ch))
            width = ch
        self.out = nn.Linear(width, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num):
            x = getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x))
            x = torch.relu(x)
        return self.out(x)
