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
* :func:`_fps_cuda` — the hand-written kernels of ``csrc/fps.cu``.

:func:`furthest_point_sample` takes the kernel for a CUDA tensor and the
plain version for a CPU tensor. Both round every squared distance as
``(dx*dx + dy*dy) + dz*dz``, so they agree bit for bit.

Which kernel a CUDA tensor takes is decided by its shape alone
(:func:`plan`): a row is spread over a thread-block cluster of R blocks
of T threads, each thread holding P points in registers, while
``R * T * P >= N`` can be met; a larger row takes the capacity kernel
(one block per row, its field in a global scratch buffer).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from backtoreality_tpu_torch.ops import _build
from backtoreality_tpu_torch.train.observability import spanned

_PAD_NORM2 = 1e-3  # squared-norm threshold below which a point is padding
_BIG = 1e10

KERNEL = _build.Kernel(
    "fps", "fps.cu",
    replaces="backtoreality_tpu/ops/fps.py:90 (_fps_kernel),"
             " :140 (_fps_kernel_row)",
    signatures={
        # cluster, threads, points -> clusters resident at once
        "fps_max_clusters": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
        # xyz, row stride, point stride, b, n, npoint, cluster, threads,
        # points, out, scratch, stream
        "fps_launch": [ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p],
    })

# What csrc/fps.cu is built for: points per thread, threads per block
# (kMaxThreads), blocks per cluster (kMaxCluster).
_POINTS = (1, 2, 4, 8, 16)
_MAX_THREADS = 512
_CLUSTERS = (16, 8, 4, 2, 1)
# Few warps keep the slot reduction short; a thread's P points give the
# sweep its parallelism.
_WARPS = 4
# A row that one block of `_WARPS` warps can hold stays in one block: up
# to there a longer sweep costs less than the exchange between blocks
# (0.40 against 0.52 us a sample at 2048 points on an H100). A longer row
# takes the largest cluster that leaves each block `_MIN_SHARD` points:
# 8 blocks at 8192 points, 16 at 40000.
_ONE_BLOCK = 32 * _WARPS * _POINTS[-1]
_MIN_SHARD = 1024


class Plan(NamedTuple):
    """How one FPS call is laid out on the card. ``cluster == 0`` is the
    capacity kernel (``threads`` and ``points`` unused)."""

    cluster: int
    threads: int
    points: int


CAPACITY = Plan(0, 0, 0)


def shard_plan(cluster: int, n: int) -> Plan | None:
    """The (threads, points) layout of an n-point row over `cluster`
    blocks, or None where the row does not fit their registers: one warp
    where it can hold the block's points (it needs no barrier: 0.27
    against 0.35 us a sample at 512 points on an H100), else the fewest
    points per thread that keep a block at `_WARPS` warps, else the most
    points per thread and as many threads as that takes."""
    shard = -(-n // cluster)
    warps = 1 if shard <= 32 * _POINTS[-1] and cluster == 1 else _WARPS
    for points in _POINTS:
        if -(-shard // points) <= 32 * warps:
            break
    threads = -(-shard // (32 * points)) * 32
    if threads > _MAX_THREADS:
        return None
    return Plan(cluster, threads, points)


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int) -> Plan:
    """The layout of a (b, n) call: one block for a row of up to
    `_ONE_BLOCK` points, else the largest cluster that leaves each block
    `_MIN_SHARD` points and of which the card holds b at once, so that
    all rows run together. Where no size holds b at once, the
    smallest cluster that fits the row (the rows then run in turns); for
    a row beyond 16 blocks of `_MAX_THREADS * _POINTS[-1]` points, the
    capacity kernel. Asks the card, so it needs the built library."""
    in_turns = CAPACITY
    for cluster in _CLUSTERS:
        if cluster > 1 and (n <= _ONE_BLOCK or n < cluster * _MIN_SHARD):
            continue
        p = shard_plan(cluster, n)
        if p is None:
            continue
        resident = b if cluster == 1 else KERNEL.lib.fps_max_clusters(*p)
        if resident >= b:
            return p
        if resident >= 1:
            in_turns = p
    return in_turns


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


@spanned("kernel.fps")
def _fps_cuda(xyz: torch.Tensor, npoint: int,
              layout: Plan | None = None) -> torch.Tensor:
    """The kernel on a CUDA tensor; `layout` overrides :func:`plan` (for
    measurements of the other layouts)."""
    if xyz.dtype != torch.float32:
        raise TypeError(f"fps kernel takes float32, got {xyz.dtype}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps expects (B, N, 3), got {tuple(xyz.shape)}")
    if xyz.stride(-1) != 1:
        xyz = xyz.contiguous()
    b, n, _ = xyz.shape
    if layout is None:
        layout = plan(b, n)
    out = torch.empty(b, npoint, dtype=torch.int32, device=xyz.device)
    scratch = (torch.empty(b, n, dtype=torch.float32, device=xyz.device)
               if layout.cluster == 0 else None)
    err = KERNEL.lib.fps_launch(
        _build.ptr(xyz), xyz.stride(0), xyz.stride(1), b, n, npoint,
        *layout, _build.ptr(out),
        None if scratch is None else _build.ptr(scratch),
        _build.stream_of(xyz))
    _build.check(err, "fps_launch")
    KERNEL.launches += 1
    KERNEL.bytes += _build.nbytes(xyz, out)
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
