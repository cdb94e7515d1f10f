"""Eval-mode BatchNorm and the ReLU after it, in one pass on the card.

``y = relu((x - mean) * inv + bias)`` over the last axis of x, with
``inv = rsqrt(var + eps) * weight`` computed by the caller
(``nn/norm.py``'s BatchNorm, whose ``forward(x, relu=True)`` is the one
entry). The plain version is the torch sequence that BatchNorm runs, with
``torch.relu`` after it: four elementwise passes. The kernel of
``csrc/bn_relu.cu`` reads x once and writes y once, and rounds each step
as that sequence does, so the two agree bit for bit: in float32, and for a
bfloat16 x (``--bf16``) with the result rounded to bfloat16 before the
ReLU, as ``.to(x.dtype)`` then ``torch.relu`` round it.

Every eval-mode BatchNorm -> ReLU on the card takes the kernel
(:func:`on_card`); :func:`bn_relu` raises on what the kernel cannot take
(:func:`refusal`), which no path of the port gives it. Training mode and
the CPU run the torch sequence.
"""

from __future__ import annotations

import ctypes

import torch

from backtoreality_tpu_torch.ops import _build
from backtoreality_tpu_torch.train.observability import spanned

KERNEL = _build.Kernel(
    "bn_relu", "bn_relu.cu",
    replaces="backtoreality_tpu/nn/norm.py:54 (BatchNorm, eval branch),"
             " with the nn.relu of backtoreality_tpu/nn/mlp.py:48, left to"
             " XLA",
    signatures={
        # x, mean, inv, bias, y, elements, channels, bf16, stream
        "bn_relu_launch": [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p],
    })

# x's alignment the kernel's four-element accesses need, by dtype
ALIGN = {torch.float32: 16, torch.bfloat16: 8}


def on_card(x: torch.Tensor) -> bool:
    """Whether an eval-mode BatchNorm -> ReLU on x is the kernel's."""
    return x.is_cuda


def refusal(x: torch.Tensor, *vectors: torch.Tensor) -> str:
    """Why the kernel cannot take relu((x - mean) * inv + bias) for these
    tensors (`vectors`: mean, inv, bias), or "" where it can: grad off,
    x float32 or bfloat16, contiguous and aligned for four elements at a
    time, its last axis a multiple of 4; the vectors float32 of x's
    width on x's device, contiguous and 16-byte aligned."""
    if torch.is_grad_enabled():
        return ("grad is on: an eval-mode forward on the card runs under"
                " torch.no_grad() or torch.inference_mode()")
    if x.dtype not in ALIGN:
        return f"x is {x.dtype}, not float32 or bfloat16"
    if x.dim() == 0 or x.shape[-1] % 4:
        return f"x's last axis ({tuple(x.shape)}) is no multiple of 4"
    if not x.is_contiguous() or x.data_ptr() % ALIGN[x.dtype]:
        return "x is not contiguous, or not aligned"
    for v in vectors:
        if (v.dtype != torch.float32 or v.device != x.device
                or v.shape != x.shape[-1:] or not v.is_contiguous()
                or v.data_ptr() % 16):
            return (f"a vector of {v.dtype} {tuple(v.shape)} on {v.device}"
                    " is not float32 of x's width on x's device, contiguous"
                    " and 16-byte aligned")
    return ""


@spanned("kernel.bn_relu")
def bn_relu(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """The kernel; y out of place, x's shape and dtype. Raises ValueError
    on what it cannot take (:func:`refusal`)."""
    why = refusal(x, mean, inv, bias)
    if why:
        raise ValueError(f"bn_relu: {why}")
    y = torch.empty_like(x)
    err = KERNEL.lib.bn_relu_launch(
        _build.ptr(x), _build.ptr(mean), _build.ptr(inv), _build.ptr(bias),
        _build.ptr(y), x.numel(), x.shape[-1],
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(err, "bn_relu_launch")
    KERNEL.launches += 1
    KERNEL.bytes += _build.nbytes(x, mean, inv, bias, y)
    return y
