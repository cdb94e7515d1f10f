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

``forward(x, relu=True)`` is BatchNorm with the ReLU after it, the one
entry for every BatchNorm -> ReLU pair of the models. In eval mode on the
card that is one pass of a hand kernel (``ops/bn_relu.py``), bit for bit
the torch sequence, float32 or bfloat16, with the scale ``rsqrt(var +
eps) * weight`` kept from one call to the next while neither tensor
changes; the kernel raises on what it cannot take (grad on, float64, a
width no multiple of 4). In training mode, and on the CPU, it is the
torch sequence with ``torch.relu`` after it.

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
from backtoreality_tpu_torch.ops import bn_relu as fused


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
        # the eval scale the kernel reads, with what it was computed from
        self._eval_scale = None

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        if relu and not self.training and fused.on_card(x):
            return fused.bn_relu(x, self.running_mean, self._scale(),
                                 self.bias)
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
        y = ((xf - mean) * inv + self.bias.to(ct)).to(x.dtype)
        return torch.relu(y) if relu else y

    def _scale(self) -> torch.Tensor:
        """The eval scale ``rsqrt(running_var + eps) * weight``, the torch
        ops of the eval branch, computed again only when either tensor has
        changed since: another tensor, another version (every in-place op
        counts one: a train step, a recalibration, a load) or other memory
        (a move). An eval forward on the card then launches the kernel
        alone a layer. A write through ``.data`` bumps no version and is
        not seen: the port's one, ``parallel.replicate``, runs before any
        forward."""
        var, weight = self.running_var, self.weight
        key = (var, var._version, var.data_ptr(), weight, weight._version,
               weight.data_ptr())
        held = self._eval_scale
        if held is None or any(
                a is not b if torch.is_tensor(a) else a != b
                for a, b in zip(held[0], key)):
            # a tensor that outlives the inference_mode of the forward
            with torch.inference_mode(False), torch.no_grad():
                held = self._eval_scale = (
                    key, torch.rsqrt(var + self.eps) * weight)
        return held[1]
