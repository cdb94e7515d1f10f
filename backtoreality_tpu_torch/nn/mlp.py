"""Shared (pointwise) MLP stacks.

Counterpart of ``backtoreality_tpu/nn/mlp.py``. Channels-last, a 1x1
conv is a Linear layer on the trailing axis. Submodules are named as in
the JAX package (``dense{i}``, ``bn{i}``, ``out``) so that weights map
across mechanically (see ``bridge.py``).

Every linear layer is a `Dense`: float32 parameters and a compute dtype of
its own, as the JAX package's ``nn.Dense(dtype=...)``; the stacks take one
`dtype` for all their layers (None: the parameters' dtype). BatchNorm
keeps its statistics in float32 and returns its input's dtype.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from backtoreality_tpu_torch.nn.norm import BatchNorm


class Dense(nn.Linear):
    """A Linear layer with a compute dtype, as the JAX package's
    ``nn.Dense(dtype=...)`` over float32 parameters: the input and the
    weight are cast to `dtype` at use, the product is rounded to it, and
    then the bias, cast too, is added (XLA rounds the product before the
    add; a fused addmm in bfloat16 would round once). `dtype` None
    computes in the parameters' dtype (float32, or float64 after
    ``.double()``), in one fused call."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        if dt == self.weight.dtype:
            return F.linear(x.to(dt), self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class SharedMLP(nn.Module):
    """(Linear without bias + BN + ReLU) per width, applied pointwise over
    the trailing axis (the reference SharedMLP activates every layer).

    in_features: input width.
    channels: output width per layer.
    dtype: the layers' compute dtype (None: the parameters').
    """

    def __init__(self, in_features: int, channels: tp.Sequence[int],
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num = len(channels)
        width = in_features
        for i, ch in enumerate(channels):
            dense = Dense(width, ch, bias=False, dtype=dtype)
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
                 out: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.num = len(hidden)
        width = in_features
        for i, ch in enumerate(hidden):
            self.add_module(f"dense{i}",
                            Dense(width, ch, bias=False, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(ch))
            width = ch
        self.out = Dense(width, out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num):
            x = getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x))
            x = torch.relu(x)
        return self.out(x)
