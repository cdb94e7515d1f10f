"""Furthest point sampling.

Counterpart of ``backtoreality_tpu/ops/fps.py``. Semantics match the
reference CUDA kernel (`detection/Votenet/pointnet2/_ext_src/src/
sampling_gpu.cu:74-177`):

* the first sample is always index 0;
* points with squared norm <= 1e-3 are skipped (the padding convention);
* each of the remaining ``npoint - 1`` iterations picks the point whose
  min-distance to the already-chosen set is largest (ties -> lowest
  index; an all-padding row gives index 0).

Two implementations of one function:

* :func:`_fps_torch` — the plain version, a Python loop over the samples
  with a masked argmax, batched over B (counterpart of ``_fps_xla``);
* :func:`_fps_cuda` — the hand-written kernel ``csrc/fps.cu``.

:func:`furthest_point_sample` takes the kernel for a CUDA tensor and the
plain version for a CPU tensor. Both round every squared distance as
``(dx*dx + dy*dy) + dz*dz``, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from backtoreality_tpu_torch.ops import _build

_PAD_NORM2 = 1e-3  # squared-norm threshold below which a point is padding
_BIG = 1e10

KERNEL = _build.Kernel(
    "fps", "fps.cu",
    replaces="backtoreality_tpu/ops/fps.py:90 (_fps_kernel),"
             " :140 (_fps_kernel_row)",
    signatures={
        "fps_needs_scratch": [ctypes.c_int],
        # xyz, row stride, point stride, b, n, npoint, out, scratch,
        # stream
        "fps_launch": [ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p],
    })


def _sq3(x, y, z):
    return (x * x + y * y) + z * z


def _fps_torch(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    b, n, _ = xyz.shape
    if xyz.dtype != torch.float64:  # f64 kept for the x64 parity tests
        xyz = xyz.float()
    x, y, z = xyz.unbind(-1)
    valid = _sq3(x, y, z) > _PAD_NORM2
    mindist = torch.where(valid, _BIG, -1.0).to(xyz.dtype)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    idxs = torch.zeros(b, npoint, dtype=torch.int32, device=xyz.device)
    for j in range(1, npoint):
        ref = xyz[rows, last]  # (B, 3)
        d = _sq3(x - ref[:, 0:1], y - ref[:, 1:2], z - ref[:, 2:3])
        mindist = torch.minimum(mindist, d)
        # first maximal index: padding stays at -1 and never wins
        last = torch.argmax(mindist, dim=-1)
        idxs[:, j] = last.to(torch.int32)
    return idxs


def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    if xyz.dtype != torch.float32:
        raise TypeError(f"fps kernel takes float32, got {xyz.dtype}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps expects (B, N, 3), got {tuple(xyz.shape)}")
    if xyz.stride(-1) != 1:
        xyz = xyz.contiguous()
    b, n, _ = xyz.shape
    lib = KERNEL.lib
    out = torch.empty(b, npoint, dtype=torch.int32, device=xyz.device)
    scratch = (torch.empty(b, n, dtype=torch.float32, device=xyz.device)
               if lib.fps_needs_scratch(n) else None)
    err = lib.fps_launch(
        _build.ptr(xyz), xyz.stride(0), xyz.stride(1), b, n, npoint,
        _build.ptr(out), None if scratch is None else _build.ptr(scratch),
        _build.stream_of(xyz))
    _build.check(err, "fps_launch")
    KERNEL.launches += 1
    return out


def furthest_point_sample(
    xyz: torch.Tensor,
    npoint: int,
    candidates: int | None = None,
) -> torch.Tensor:
    """Iterative furthest point sampling.

    Args:
      xyz: (B, N, 3) point coordinates. Points with ||p||^2 <= 1e-3 are
        treated as padding and never sampled.
      npoint: number of samples to draw.
      candidates: optional throughput knob — run FPS over only the first
        `candidates` points (the input pipeline random-permutes clouds,
        so the prefix is a uniform random subset).

    Returns:
      (B, npoint) int32 indices into N. Index 0 is always the first
      sample. A CUDA tensor runs the kernel, a CPU tensor the plain
      version.
    """
    # integer-valued op: no gradient (the reference marks backward None)
    xyz = xyz.detach()
    if candidates is not None and candidates < xyz.shape[1]:
        xyz = xyz[:, :candidates]
    if xyz.is_cuda:
        return _fps_cuda(xyz, npoint)
    if xyz.device.type != "cpu":
        raise ValueError(f"no fps for device {xyz.device}")
    return _fps_torch(xyz, npoint)
