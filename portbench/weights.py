"""A detector's weights, made on the card from the run's seed.

Every matrix (a parameter named ``*.weight`` with two dimensions) is
drawn from one normal draw of a ``torch.Generator`` on the device and
scaled to He's standard deviation sqrt(2 / fan_in); every other
``*.weight`` (BatchNorm's and LayerNorm's scales) is 1, every ``*.bias``
and ``running_mean`` 0, every ``running_var`` 1. The benchmark hands the
same weights to the system and to the reference.
"""

from __future__ import annotations

import hashlib
import math

import torch


def generator(device, seed: int, *key: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, *key) alone."""
    digest = hashlib.sha256(repr((int(seed),) + key).encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") >> 1)


def make(shapes: dict, seed: int, device) -> dict:
    """`shapes`: name -> torch.Size of a state dict. Returns name ->
    float32 tensor on `device`."""
    matrices = [n for n, s in shapes.items()
                if n.endswith(".weight") and len(s) == 2]
    total = sum(shapes[n].numel() for n in matrices)
    draw = torch.randn(total, generator=generator(device, seed, 2),
                       device=device)
    out, at = {}, 0
    for name in matrices:
        shape = shapes[name]
        out[name] = draw[at:at + shape.numel()].view(shape).mul_(
            math.sqrt(2.0 / shape[1]))
        at += shape.numel()
    for name, shape in shapes.items():
        if name in out:
            continue
        fill = 1.0 if name.endswith((".weight", "running_var")) else 0.0
        if not name.endswith((".weight", ".bias", "running_mean",
                              "running_var")):
            raise ValueError(f"no rule for the state entry {name}")
        out[name] = torch.full(shape, fill, device=device)
    return out
