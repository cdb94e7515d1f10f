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

`group_localize_stratified` is the grouping of a set-abstraction layer
with its localize step: the centre subtracted from the grouped
coordinates, the division by the radius, and the grouped features beside
them (the counterpart of ``_group`` in ``backtoreality_tpu/nn/sa_fp.py``
with ``use_xyz`` and ``normalize_xyz`` on). Again two implementations:
:func:`_group_localize_stratified_torch`, the plain composition, and
:class:`_GroupLocalizeCuda`, a second entry into the same kernels that
reads coordinates and features as two inputs and writes the layer's input
in one pass; its backward is the same three passes plus a small kernel for
the factor 1 / radius of the coordinates' gradient and the centres'
gradient, where those are needed.
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
        # xyz, features (or null), new_xyz, idx, b, n, m, nsample, c,
        # radius, out, stream
        "group_localize_fwd_launch": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_void_p],
        # gout, idx, hit, b, n, m, nsample, bucket, c (3 + features),
        # 1 / radius, start, list, fold, grad, whether xyz needs its
        # gradient, gcentre (or null), stream
        "group_localize_bwd_launch": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    })
# `KERNEL.launches` and `KERNEL.backward_launches` count the launches of
# the source's forward kernel and of its backward passes, through either
# entry; `LOCALIZE` counts those made through the fused entry.
LOCALIZE = _build.Entry(
    KERNEL, "group_localize_stratified",
    replaces=KERNEL.replaces + ", with the localize step of"
    " backtoreality_tpu/nn/sa_fp.py:24 (_group)")


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


def _resample_uniformly(idx: torch.Tensor, u: torch.Tensor):
    """:func:`sample_uniformly` with its uniform draws `u` (idx.shape,
    float32 in [0, 1)) given: each slot-filled slot takes
    ``idx[..., j]``, j = min(floor(u * cnt), cnt - 1)."""
    s = idx.shape[-1]
    slot = torch.arange(s, device=idx.device)
    # distinct neighbours: slot 0 and every slot unlike the fill idx[..., 0]
    valid = (slot == 0) | (idx != idx[..., :1])
    cnt = torch.sum(valid, dim=-1, dtype=torch.int32)  # (B, M)
    j = torch.minimum((u * cnt[..., None]).to(torch.int32),
                      cnt[..., None] - 1)
    resampled = torch.gather(idx, -1, j.long())
    return torch.where(valid, idx, resampled), cnt


def sample_uniformly(idx: torch.Tensor, generator: torch.Generator):
    """Spread slot-fill duplicates uniformly over a region's found
    neighbours (`QueryAndGroup(sample_uniformly=True)`,
    `pointnet2_utils.py:336-345`; the counterpart of the JAX package's
    ``ops.grouping.sample_uniformly``, unused by every train path).

    The exact ball query fills unfound slots with a copy of the first
    in-radius index: found (distinct) neighbours occupy the slot prefix
    [0, cnt) and every later slot equals idx[..., 0]. Each fill slot takes
    idx[..., j] instead, j uniform over 0..cnt-1 (the JAX package's
    arithmetic, on uniform draws from `generator`).

    Args:
      idx: (B, M, S) int32 from `ball_query` (first-k, slot-fill).
      generator: the ``torch.Generator`` of the draws, on idx's device;
        the global generator is never read.

    Returns:
      (idx_resampled, unique_cnt): (B, M, S) int32 and (B, M) int32.
    """
    if not isinstance(generator, torch.Generator):
        raise TypeError("sample_uniformly draws from a torch.Generator the"
                        f" caller passes, got {type(generator).__name__}")
    u = torch.rand(idx.shape, generator=generator, device=idx.device)
    return _resample_uniformly(idx, u)


def _group_points_stratified_torch(points, idx, hit):
    del hit  # idx is already slot-filled
    return group_points(points, idx)


def _group_localize_stratified_torch(xyz, features, new_xyz, idx, hit,
                                     radius):
    points = xyz if features is None else torch.cat([xyz, features], -1)
    grouped = _group_points_stratified_torch(points, idx, hit)
    # a tensor divisor: a true division on every device (by a Python
    # number, a CUDA tensor is multiplied by the reciprocal)
    r = torch.full((), radius, dtype=xyz.dtype, device=xyz.device)
    local_xyz = (grouped[..., :3] - new_xyz[:, :, None, :]) / r
    if features is None:
        return local_xyz
    return torch.cat([local_xyz, grouped[..., 3:]], -1)


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
        KERNEL.bytes += _build.nbytes(points, idx, out)
        ctx.save_for_backward(idx, hit.contiguous())
        ctx.n = n
        return out

    @staticmethod
    def backward(ctx, gout):
        idx, hit = ctx.saved_tensors
        grad, _ = _backward_passes(gout, idx, hit, ctx.n)
        return grad, None, None


def _backward_passes(gout, idx, hit, n, radius=None, want_xyz=False,
                     want_centres=False):
    """The three passes over gout (b, m, s, c): grad (b, n, c), and None.
    With a `radius`, the backward of the fused entry: with `want_xyz`,
    grad[..., :3] is multiplied by 1 / radius (the gradient of xyz; else
    those channels are not to be read), and with `want_centres` the second
    result is the gradient of the centres (b, m, 3)."""
    if gout.dtype != torch.float32:
        raise TypeError(f"grouping backward takes float32, got"
                        f" {gout.dtype}")
    gout = gout.contiguous()
    b, m, s, c = gout.shape
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
    head = (_build.ptr(gout), _build.ptr(idx), _build.ptr(hit), b, n, m, s,
            bucket, c)
    scratch = (_build.ptr(ints), lists, _build.ptr(fold), _build.ptr(grad))
    gcentre = None
    if radius is None:
        err = KERNEL.lib.group_stratified_bwd_launch(
            *head, *scratch, _build.stream_of(gout))
        _build.check(err, "group_stratified_bwd_launch")
    else:
        if want_centres:
            gcentre = torch.empty(b, m, 3, dtype=torch.float32, device=dev)
        err = KERNEL.lib.group_localize_bwd_launch(
            *head, 1.0 / radius, *scratch, int(want_xyz),
            None if gcentre is None else _build.ptr(gcentre),
            _build.stream_of(gout))
        _build.check(err, "group_localize_bwd_launch")
        LOCALIZE.backward_launches += 1
    KERNEL.backward_launches += 1
    KERNEL.bytes += _build.nbytes(gout, idx, hit, grad, gcentre)
    return grad, gcentre


class _GroupLocalizeCuda(torch.autograd.Function):
    """Forward: the gather kernel's fused entry (coordinates localized,
    features beside them). Backward: the same three passes over the whole
    row, whose channels 0-2 are the gradient of xyz and the rest that of
    the features (views of one tensor), and the centres' gradient where it
    is needed; bitwise repeatable."""

    @staticmethod
    def forward(ctx, xyz, features, new_xyz, idx, hit, radius):
        points = xyz if features is None else features
        _check_cuda_args(points, idx, hit)
        b, n = xyz.shape[:2]
        m, s = idx.shape[1], idx.shape[2]
        if xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32:
            raise TypeError(f"grouping kernel takes float32 coordinates, got"
                            f" {xyz.dtype} and {new_xyz.dtype}")
        if (tuple(xyz.shape) != (idx.shape[0], n, 3)
                or tuple(new_xyz.shape) != (b, m, 3)
                or (features is not None and features.shape[:2] != (b, n))):
            raise ValueError(
                f"expected xyz (B, N, 3), features (B, N, C) or None and"
                f" new_xyz (B, M, 3); got {tuple(xyz.shape)},"
                f" {None if features is None else tuple(features.shape)},"
                f" {tuple(new_xyz.shape)}")
        for name, t in (("features", features), ("new_xyz", new_xyz)):
            if t is not None and t.device != xyz.device:
                raise ValueError(f"{name} is on {t.device}, xyz on"
                                 f" {xyz.device}")
        xyz = xyz.contiguous()
        new_xyz = new_xyz.contiguous()
        idx = idx.contiguous()
        c = 0
        if features is not None:
            features = features.contiguous()
            c = features.shape[2]
        out = torch.empty(b, m, s, 3 + c, dtype=torch.float32,
                          device=xyz.device)
        err = KERNEL.lib.group_localize_fwd_launch(
            _build.ptr(xyz), None if features is None
            else _build.ptr(features), _build.ptr(new_xyz), _build.ptr(idx),
            b, n, m, s, c, radius, _build.ptr(out), _build.stream_of(xyz))
        _build.check(err, "group_localize_fwd_launch")
        KERNEL.launches += 1
        LOCALIZE.launches += 1
        KERNEL.bytes += _build.nbytes(xyz, features, new_xyz, idx, out)
        ctx.save_for_backward(idx, hit.contiguous())
        ctx.n = n
        ctx.radius = radius
        return out

    @staticmethod
    def backward(ctx, gout):
        idx, hit = ctx.saved_tensors
        need_xyz, need_features, need_centres = ctx.needs_input_grad[:3]
        grad, gcentre = _backward_passes(gout, idx, hit, ctx.n, ctx.radius,
                                         want_xyz=need_xyz,
                                         want_centres=need_centres)
        return (grad[..., :3] if need_xyz else None,
                grad[..., 3:] if need_features else None,
                gcentre, None, None, None)


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


def group_localize_stratified(xyz: torch.Tensor,
                              features: torch.Tensor | None,
                              new_xyz: torch.Tensor, idx: torch.Tensor,
                              hit: torch.Tensor,
                              radius: float) -> torch.Tensor:
    """Grouping and the localize step of a set-abstraction layer in one.

    Args:
      xyz: (B, N, 3) coordinates.
      features: (B, N, C) features, or None.
      new_xyz: (B, M, 3) the centres.
      idx, hit: (B, M, S) from
        ``ball_query_stratified(xyz, new_xyz, radius, S, return_hit=True)``.
      radius: the layer's radius.

    Returns:
      (B, M, S, 3 + C): channels 0-2 are
      ``(xyz[b, idx] - new_xyz[b, m]) / radius`` (one subtraction, then one
      division), the rest ``features[b, idx]``; (B, M, S, 3) without
      features. Differentiable in `xyz`, `features` and `new_xyz`. A CUDA
      tensor runs the kernel (its backward is bitwise repeatable), a CPU
      tensor the plain version.
    """
    if xyz.is_cuda:
        return _GroupLocalizeCuda.apply(xyz, features, new_xyz, idx, hit,
                                        float(radius))
    if xyz.device.type != "cpu":
        raise ValueError(f"no stratified grouping for device {xyz.device}")
    return _group_localize_stratified_torch(xyz, features, new_xyz, idx,
                                            hit, radius)
