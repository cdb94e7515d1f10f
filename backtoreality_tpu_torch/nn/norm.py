"""Batch normalization with torch-style momentum, channels-last.

Counterpart of ``BatchNorm`` in ``backtoreality_tpu/nn/norm.py``, with
the same arithmetic order: batch moments from E[x] and E[x^2], the
normalisation ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, and
running statistics updated as

    running = (1 - momentum) * running + momentum * batch_stat

with the unbiased batch variance. The momentum is rounded to float32 and
``1 - momentum`` taken in float32, as the JAX package does with its
call-time ``bn_momentum``; :func:`set_bn_momentum` sets it on every
BatchNorm of a model before a step, and :func:`bn_momentum_schedule` is
the reference's epoch schedule.

In a process group of W > 1 ranks (``parallel``) the train-mode moments
are the global batch's, as the JAX package's on a device mesh: the local
E[x] and E[x^2] are all-reduced (one collective a layer) and divided by
W, the unbiased count is the local count times W, and the gradient flows
through the collective.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from backtoreality_tpu_torch import parallel


def bn_momentum_schedule(epoch: int, init: float = 0.5,
                         decay_step: int = 20, decay_rate: float = 0.5,
                         floor: float = 0.001) -> float:
    """Reference BN momentum schedule (`train_Votenet_FSB.py:91-95`)."""
    return max(init * decay_rate ** (epoch // decay_step), floor)


def set_bn_momentum(model: nn.Module, momentum: float):
    """Set the running-statistics momentum of every BatchNorm in
    `model` (the JAX package passes it to each train-mode call)."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.momentum = momentum


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
            count = xf.numel() // self.features
            world = parallel.world()
            if world > 1:
                # the global batch's moments, as the JAX package's on a
                # mesh (pmean); the gradient flows through the sum
                mean, mean2 = parallel.all_reduce_sum(
                    torch.stack([mean, mean2])) / world
                count *= world
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            unbiased = var * (count / max(count - 1, 1))
            m = np.float32(self.momentum)
            keep = float(np.float32(1) - m)
            m = float(m)
            with torch.no_grad():
                self.running_mean.copy_(keep * self.running_mean + m * mean)
                self.running_var.copy_(keep * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean.to(ct), self.running_var.to(ct)
        inv = torch.rsqrt(var + self.eps) * self.weight.to(ct)
        y = (xf - mean) * inv + self.bias.to(ct)
        return y.to(x.dtype)
