"""Index gathers for point sets.

Counterpart of ``backtoreality_tpu/ops/grouping.py``: the reference CUDA
ops `gather_points` / `group_points` (`sampling_gpu.cu:13-62`,
`group_points_gpu.cu:13-86`) as plain ``torch.gather``, channels-last
(B, N, C). Autograd's transpose of a gather is the scatter-add backward.

`group_points_stratified` groups the output of the stratified ball
query. Two implementations of one function:

* :func:`_group_points_stratified_torch` — the plain version,
  ``group_points(points, idx)`` with autograd's backward;
* :class:`_GroupStratifiedCuda` — the hand-written kernel
  ``csrc/group_stratified.cu`` (counterpart of the Pallas kernel
  ``_group_bucketed_kernel`` and its custom VJP), whose backward is a
  deterministic segmented reduction with no float atomics: the lists of
  contributions per point are built once per call, then summed in order.
"""

from __future__ import annotations

import ctypes

import torch

from backtoreality_tpu_torch.ops import _build
from backtoreality_tpu_torch.ops.ball_query import _bucket_size

KERNEL = _build.Kernel(
    "group_stratified", "group_stratified.cu",
    replaces="backtoreality_tpu/ops/grouping.py:145"
             " (_group_bucketed_kernel)",
    signatures={
        # points, idx, b, n, m, nsample, c, out, stream
        "group_stratified_fwd_launch": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p],
        # gout, idx, hit, b, n, m, nsample, bucket, c, start, list, fold,
        # grad, stream
        "group_stratified_bwd_launch": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    })


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (B, N, C) by (B, M) -> (B, M, C)."""
    c = points.shape[-1]
    index = idx.long()[..., None].expand(-1, -1, c)
    return torch.gather(points, 1, index)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (B, N, C) by (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    flat = gather_points(points, idx.reshape(b, m * s))
    return flat.reshape(b, m, s, points.shape[-1])


def _group_points_stratified_torch(points, idx, hit):
    del hit  # idx is already slot-filled
    return group_points(points, idx)


def _check_cuda_args(points, idx, hit):
    if points.dtype != torch.float32:
        raise TypeError(f"grouping kernel takes float32 points, got"
                        f" {points.dtype}")
    if points.dim() != 3 or idx.dim() != 3 or hit.shape != idx.shape:
        raise ValueError(f"expected points (B, N, C), idx and hit (B, M, S);"
                         f" got {tuple(points.shape)}, {tuple(idx.shape)},"
                         f" {tuple(hit.shape)}")
    if idx.dtype != torch.int32 or hit.dtype != torch.bool:
        raise TypeError(f"idx must be int32 and hit bool, got {idx.dtype}"
                        f" and {hit.dtype}")
    for name, t in (("idx", idx), ("hit", hit)):
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, points on"
                             f" {points.device}")
    if idx.shape[0] != points.shape[0]:
        raise ValueError("points and idx must share the batch dimension")


class _GroupStratifiedCuda(torch.autograd.Function):
    """Forward: the gather kernel. Backward: the lists, fold and reduce
    passes, a fixed-order sum per point (bitwise repeatable)."""

    @staticmethod
    def forward(ctx, points, idx, hit):
        _check_cuda_args(points, idx, hit)
        points = points.contiguous()
        idx = idx.contiguous()
        b, n, c = points.shape
        m, s = idx.shape[1], idx.shape[2]
        out = torch.empty(b, m, s, c, dtype=torch.float32,
                          device=points.device)
        err = KERNEL.lib.group_stratified_fwd_launch(
            _build.ptr(points), _build.ptr(idx), b, n, m, s, c,
            _build.ptr(out), _build.stream_of(points))
        _build.check(err, "group_stratified_fwd_launch")
        KERNEL.launches += 1
        ctx.save_for_backward(idx, hit.contiguous())
        ctx.n = n
        return out

    @staticmethod
    def backward(ctx, gout):
        idx, hit = ctx.saved_tensors
        if gout.dtype != torch.float32:
            raise TypeError(f"grouping backward takes float32, got"
                            f" {gout.dtype}")
        gout = gout.contiguous()
        b, m, s, c = gout.shape
        n = ctx.n
        bucket = _bucket_size(n, s)
        live = -(-n // bucket)  # strata that hold a point
        dev = gout.device
        # one allocation for the lists' two arrays: start (b, live,
        # bucket + 1), then list (b, live, 2 m)
        cells = b * live
        ints = torch.empty(cells * (bucket + 1 + 2 * m), dtype=torch.int32,
                           device=dev)
        lists = ctypes.c_void_p(ints.data_ptr() + 4 * cells * (bucket + 1))
        fold = torch.empty(b, m, c, dtype=torch.float32, device=dev)
        grad = torch.empty(b, n, c, dtype=torch.float32, device=dev)
        err = KERNEL.lib.group_stratified_bwd_launch(
            _build.ptr(gout), _build.ptr(idx), _build.ptr(hit), b, n, m, s,
            bucket, c, _build.ptr(ints), lists, _build.ptr(fold),
            _build.ptr(grad), _build.stream_of(gout))
        _build.check(err, "group_stratified_bwd_launch")
        KERNEL.backward_launches += 1
        return grad, None, None


def group_points_stratified(points: torch.Tensor, idx: torch.Tensor,
                            hit: torch.Tensor) -> torch.Tensor:
    """`group_points` for stratified ball-query output.

    Args:
      points: (B, N, C) values to group.
      idx: (B, M, S) int32 indices from
        ``ball_query_stratified(..., return_hit=True)`` (slot-filled with
        each centre's first hit, index 0 for a centre with no hit).
      hit: (B, M, S) bool mask from the same call.

    Returns:
      (B, M, S, C) == ``group_points(points, idx)``, differentiable in
      `points`. A CUDA tensor runs the kernel (its backward is bitwise
      repeatable), a CPU tensor the plain version.
    """
    if points.is_cuda:
        return _GroupStratifiedCuda.apply(points, idx, hit)
    if points.device.type != "cpu":
        raise ValueError(f"no stratified grouping for device"
                         f" {points.device}")
    return _group_points_stratified_torch(points, idx, hit)
