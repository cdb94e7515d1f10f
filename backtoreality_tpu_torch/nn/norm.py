"""Batch normalization with torch-style momentum, channels-last.

Counterpart of ``BatchNorm`` in ``backtoreality_tpu/nn/norm.py``, with
the same arithmetic order: batch moments from E[x] and E[x^2], the
normalisation ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, and
running statistics updated as

    running = (1 - momentum) * running + momentum * batch_stat

with the unbiased batch variance. ``bn_momentum_schedule`` comes with the
training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm over the channel (last) axis; normalizes over all other
    axes. weight (gamma) init 1, bias (beta) init 0, eps 1e-5."""

    eps = 1e-5

    def __init__(self, features: int, momentum: float = 0.1):
        super().__init__()
        self.features = features
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # f32, or f64 in the x64 parity tests — never stats in bf16
        ct = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(ct)
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=dims)
            mean2 = (xf * xf).mean(dim=dims)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            count = xf.numel() // self.features
            unbiased = var * (count / max(count - 1, 1))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(
                    (1 - m) * self.running_mean + m * mean)
                self.running_var.copy_(
                    (1 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean.to(ct), self.running_var.to(ct)
        inv = torch.rsqrt(var + self.eps) * self.weight.to(ct)
        y = (xf - mean) * inv + self.bias.to(ct)
        return y.to(x.dtype)
