"""Stratified ball query: fixed-size neighbourhoods within a radius.

Counterpart of ``ball_query_stratified`` in
``backtoreality_tpu/ops/ball_query.py``: the N points are split into
``nsample`` contiguous buckets and each slot takes the first hit of its
bucket; empty slots are filled with the globally first hit (the first
hit of the first non-empty bucket), and a centre with no hit at all
gets index 0 in every slot. Because detection clouds are randomly
permuted by the input pipeline, this is a stratified sample of the same
neighbourhood that the reference's "first k in index order" query
returns.

Two implementations of one function:

* :func:`_ball_query_stratified_torch` — the plain version, chunked
  dense distances in the expanded form (counterpart of
  ``_ball_query_stratified_xla`` and ``_stratified_math``);
* :func:`_ball_query_stratified_cuda` — the hand-written kernel
  ``csrc/ball_query.cu``, which tests ``|c - p|^2 < r^2`` directly.

They can disagree only on points within rounding error of the radius.
The exact first-k ``ball_query`` (``query_mode=exact``) is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from backtoreality_tpu_torch.ops import _build

KERNEL = _build.Kernel(
    "ball_query", "ball_query.cu",
    replaces="backtoreality_tpu/ops/ball_query.py:230"
             " (_bq_stratified_kernel)",
    signatures={
        # xyz and its two strides, centres and theirs, b, n, m, r^2,
        # nsample, bucket, idx, hit, stream
        "bq_stratified_launch": [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p],
    })
_MAX_SLOTS = 64  # kMaxSlots in csrc/ball_query.cu
_CHUNK = 256  # centres per dense (B, chunk, N) distance block


def _bucket_size(n: int, nsample: int) -> int:
    """Stratified-bucket width: ceil(n/nsample), lane-aligned to 128 so
    the Pallas kernel's bucketed reshape stays on the fast path. The
    bucket layout is part of the stratified semantics — the XLA
    implementation and the numpy oracle use the same width."""
    return max(-(-(-(-n // nsample)) // 128) * 128, 128)


def _sq3_sum(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) as (x*x + y*y) + z*z."""
    x, y, z = v.unbind(-1)
    return (x * x + y * y) + z * z


def _pairwise_d2(new_xyz: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N) squared distances in the
    expanded form |c|^2 - 2 c.p + |p|^2 (a full-precision f32 product;
    the JAX package runs it at HIGHEST precision)."""
    cross = torch.matmul(new_xyz, xyz.transpose(-1, -2))
    c2 = _sq3_sum(new_xyz)[..., :, None]
    p2 = _sq3_sum(xyz)[..., None, :]
    return c2 - 2.0 * cross + p2


def _stratified_math(d2, r2, n, nsample, bucket):
    """d2: (..., M, S*bucket) squared distances (padding far away).
    Returns (..., M, S) int32 indices and the (..., M, S) hit mask."""
    mask = d2 < r2
    mask_b = mask.reshape(mask.shape[:-1] + (nsample, bucket))
    has_hit = mask_b.any(dim=-1)  # (..., M, S)
    # argmax returns the first maximal position: the bucket's first hit
    local = torch.where(has_hit, mask_b.to(torch.uint8).argmax(dim=-1), 0)
    base = torch.arange(nsample, device=d2.device) * bucket
    idx = base + local
    # first non-empty bucket (0 if none): its first hit is the global one
    first_bucket = has_hit.to(torch.uint8).argmax(dim=-1, keepdim=True)
    fill = torch.gather(idx, -1, first_bucket)
    out = torch.where(has_hit, idx, fill)
    return torch.clamp(out, max=n - 1).to(torch.int32), has_hit


def _ball_query_stratified_torch(xyz, new_xyz, radius, nsample):
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    # python-double product rounded once to f32, as jnp.float32(r * r)
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    xyz = xyz.float()
    new_xyz = new_xyz.float()
    bucket = _bucket_size(n, nsample)
    n_pad = bucket * nsample
    if n_pad != n:
        # pad far away so padded entries never register as hits
        pad = torch.full((b, n_pad - n, 3), 1e6, dtype=torch.float32,
                         device=xyz.device)
        xyz = torch.cat([xyz, pad], dim=1)
    outs, hits = [], []
    for start in range(0, m, _CHUNK):
        d2 = _pairwise_d2(new_xyz[:, start:start + _CHUNK], xyz)
        idx, hit = _stratified_math(d2, r2.to(d2.device), n, nsample,
                                    bucket)
        outs.append(idx)
        hits.append(hit)
    return torch.cat(outs, dim=1), torch.cat(hits, dim=1)


def _ball_query_stratified_cuda(xyz, new_xyz, radius, nsample):
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dtype != torch.float32:
            raise TypeError(f"ball query kernel takes float32 {name},"
                            f" got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be (B, *, 3), got"
                             f" {tuple(t.shape)}")
    if new_xyz.device != xyz.device or new_xyz.shape[0] != xyz.shape[0]:
        raise ValueError("xyz and new_xyz must share device and batch")
    if not 0 < nsample <= _MAX_SLOTS:
        raise ValueError(f"nsample must be in 1..{_MAX_SLOTS}, got"
                         f" {nsample}")
    xyz = xyz if xyz.stride(-1) == 1 else xyz.contiguous()
    new_xyz = new_xyz if new_xyz.stride(-1) == 1 else new_xyz.contiguous()
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=xyz.device)
    hit = torch.empty(b, m, nsample, dtype=torch.bool, device=xyz.device)
    err = KERNEL.lib.bq_stratified_launch(
        _build.ptr(xyz), xyz.stride(0), xyz.stride(1),
        _build.ptr(new_xyz), new_xyz.stride(0), new_xyz.stride(1),
        b, n, m, radius * radius, nsample, _bucket_size(n, nsample),
        _build.ptr(idx), _build.ptr(hit), _build.stream_of(xyz))
    _build.check(err, "bq_stratified_launch")
    KERNEL.launches += 1
    return idx, hit


def ball_query_stratified(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    radius: float,
    nsample: int,
    return_hit: bool = False,
):
    """Bucketed ball query (see module docstring).

    Args:
      xyz: (B, N, 3) points.
      new_xyz: (B, M, 3) query centres.
      radius: ball radius.
      nsample: slots per centre.
      return_hit: also return the (B, M, nsample) bool mask of slots
        whose bucket had a real hit (False = slot-filled).

    Returns:
      (B, M, nsample) int32 indices into N (and the hit mask). A CUDA
      tensor runs the kernel, a CPU tensor the plain version.
    """
    # integer-valued op: no gradient
    xyz = xyz.detach()
    new_xyz = new_xyz.detach()
    if xyz.is_cuda:
        idx, hit = _ball_query_stratified_cuda(xyz, new_xyz, radius,
                                               nsample)
    elif xyz.device.type == "cpu":
        idx, hit = _ball_query_stratified_torch(xyz, new_xyz, radius,
                                                nsample)
    else:
        raise ValueError(f"no ball query for device {xyz.device}")
    return (idx, hit) if return_hit else idx
