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
* :func:`_ball_query_stratified_cuda` — the hand-written kernels of
  ``csrc/ball_query.cu``, which test ``|p|^2 - 2 c.p < r^2 - |c|^2`` by
  the same operations in the same order in every tile, so that a row's
  slots do not depend on the tile :func:`plan` picks, nor on the rows of
  a launch.

The plain version sums ``c.p`` by a matrix product, so it can disagree
with the kernels only on points within rounding error of the radius.

The exact first-k query of the reference, :func:`ball_query`
(``query_mode=exact``, the mode reference-trained checkpoints expect),
which the JAX package leaves to XLA (``backtoreality_tpu/ops/
ball_query.py:71-135``), has two implementations too:

* :func:`_ball_query_exact_torch` — the plain version, a chunked top-k
  over an ordering key (the JAX function's counterpart);
* :func:`_ball_query_exact_cuda` — the hand-written kernels of
  ``csrc/ball_query.cu`` (``bq_exact_launch``), in two mappings that give
  the same slots bit for bit: a warp per centre walks the points in index
  order and leaves at its `nsample`-th hit (lanes on points, float32 and
  float64), or a block stages its row in shared memory a round at a time
  (one ``cp.async.bulk`` a round) and a lane holds centres (float32),
  with the stratified kernels' radius
  test in float32 and the plain version's direct form in float64.

How a CUDA call is laid out on the card is decided by its shape alone
(:func:`plan`, :func:`exact_plan`): which of the source's two mappings it
takes (a lane holds centres and the points come from shared memory, or a
lane holds points and the warp finds its hits by vote), the centres and
warps of a block and the centres a lane holds. :func:`tiles` and
:func:`exact_tiles` list every tile the plans may pick for a shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from backtoreality_tpu_torch.ops import _build

KERNEL = _build.Kernel(
    "ball_query", "ball_query.cu",
    replaces="backtoreality_tpu/ops/ball_query.py:230"
             " (_bq_stratified_kernel)",
    signatures={
        # xyz and its two strides, centres and theirs, b, n, m, r^2,
        # nsample, bucket, the tile (mapping, centres, warps, per_lane),
        # idx, hit, counter of executed tests (or null), stream
        "bq_stratified_launch": [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p],
        # xyz (rows of 3 or 4 contiguous values) and its two strides,
        # centres and theirs, b, n, m, r^2, nsample, whether float64, the
        # tile (mapping, centres, warps, per_lane), idx, counter of
        # executed tests (or null), stream
        "bq_exact_launch": [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p],
    })
# `KERNEL.launches` counts the stratified query's launches; `EXACT` those
# of the exact first-k query, a kernel of the same source
EXACT = _build.Entry(
    KERNEL, "ball_query_exact",
    replaces="backtoreality_tpu/ops/ball_query.py:71 (ball_query, left to"
             " XLA)")
_CHUNK = 256  # centres per dense (B, chunk, N) distance block

# What csrc/ball_query.cu is built for (its constants of the same names).
_MAX_SLOTS = 64  # kMaxSlots
_POINT_CHUNK = 128  # kChunk: points staged, or held by a warp, at a time
_MAX_WARPS = 16  # kMaxWarps
_MAX_CENTRES = 256  # kMaxCentres, per block
_MAX_POINT_CENTRES = 32  # kMaxPointCentres: the same where lanes hold points
_MAX_SMEM = 99 * 1024  # kMaxSmem, bytes per block
_PER_LANE = (1, 2, 4)  # centres a lane can hold
_SMS = 132  # streaming multiprocessors of an H100
# distance tests of a row (centres x points) from which lanes on centres
# pay where a bucket is one chunk
_CENTRE_LANES_WORK = 1 << 20

CENTRES_IN_LANES = 0  # points from shared memory, several centres a lane
POINTS_IN_LANES = 1  # a vote per 128 points, centres from shared memory

# the exact query's (`bq_exact_launch`)
_EXACT_WARPS = 8  # kExactWarps: centres and warps a block, lanes on points
_ROW_CHUNK = 64  # kRowChunk: points a warp tests a round, lanes on centres
_RING_STAGES = 2  # kRingStages


class Plan(NamedTuple):
    """The tile of one ball-query call: the mapping, the centres and warps
    of a block, and the centres a lane holds (1 where lanes hold
    points)."""

    mapping: int
    centres: int
    warps: int
    per_lane: int


def smem_bytes(tile: Plan, nsample: int) -> int:
    """Shared memory of a block, as the launcher computes it: the table of
    first hits and the fills, and the staged chunks (two buffers per bucket
    group) or the centres."""
    table = 4 * (tile.centres * (nsample + 1) + tile.centres)
    if tile.mapping == CENTRES_IN_LANES:
        groups = tile.centres // (32 * tile.per_lane)
        return table + (tile.warps // groups) * 2 * 3 * _POINT_CHUNK * 4
    return table + 16 * tile.centres


def blocks(tile: Plan | ExactTile, b: int, m: int) -> int:
    return b * -(-m // tile.centres)


def _pow2_floor(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


def _pow2_ceil(v: int) -> int:
    return 1 << (max(v, 1) - 1).bit_length()


def _bucket_size(n: int, nsample: int) -> int:
    """Stratified-bucket width: ceil(n/nsample), lane-aligned to 128 so
    the Pallas kernel's bucketed reshape stays on the fast path. The
    bucket layout is part of the stratified semantics — the XLA
    implementation and the numpy oracle use the same width."""
    return max(-(-(-(-n // nsample)) // 128) * 128, 128)


@functools.lru_cache(maxsize=None)
def tiles(b: int, n: int, m: int, nsample: int) -> tuple[Plan, ...]:
    """Every tile :func:`plan` may pick for a (b, n, m, nsample) call, all
    inside the limits `csrc/ball_query.cu` checks. Lanes on centres: 1, 2
    or 4 centres a lane, one or two centre groups a block, and as many
    bucket groups as make 8 warps (fewer where fewer buckets hold a
    point). Lanes on points: 4 to 32 centres a block, a warp per live
    bucket up to 16 (at the first layer's shape 16 warps a block are a
    tenth faster than 8 on an H100). No tile is wider than the centres of
    a row."""
    del b  # the tiles depend on a row's shape alone
    live = -(-n // _bucket_size(n, nsample))  # buckets that hold a point
    widest = min(max(32, _pow2_ceil(m)), _MAX_CENTRES)
    found = []
    for per_lane in _PER_LANE:
        for groups in (1, 2):
            centres = 32 * per_lane * groups
            if centres <= widest:
                bucket_groups = min(8 // groups, _pow2_floor(live))
                found.append(Plan(CENTRES_IN_LANES, centres,
                                  groups * bucket_groups, per_lane))
    for centres in (4, 8, 16, 32):
        if centres <= min(widest, _MAX_POINT_CENTRES):
            found.append(Plan(POINTS_IN_LANES, centres,
                              min(_MAX_WARPS, live), 1))
    return tuple(t for t in found if smem_bytes(t, nsample) <= _MAX_SMEM)


def _widest_filling(options, b: int, m: int) -> Plan | None:
    """Of `options`, the tile with the most centres a block that still
    gives every SM two blocks; where none does, one block; else None."""
    for fill in (2 * _SMS, _SMS):
        enough = [t for t in options if blocks(t, b, m) >= fill]
        if enough:
            return max(enough, key=lambda t: t.centres)
    return None


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, m: int, nsample: int) -> Plan:
    """The tile of a (b, n, m, nsample) call.

    Lanes on points as the rule: a centre leaves a bucket at its own first
    hit, which saves a third of the tests where a bucket is several chunks
    (0.209 against 0.366 ms at the first layer, 40000 points in buckets of
    640, on an H100). Where a bucket is one chunk that exit never comes
    early, and once a row has `_CENTRE_LANES_WORK` tests the cheaper test
    of lanes on centres wins (0.017 against 0.019 ms at 2048 points and
    1024 centres a row); below that the two are level or lanes on points
    ahead. Either way the widest tile that fills the card, and where the
    centres are too few for that, the narrowest tile of lanes on points."""
    options = tiles(b, n, m, nsample)
    if (_bucket_size(n, nsample) == _POINT_CHUNK
            and m * n >= _CENTRE_LANES_WORK):
        tile = _widest_filling([t for t in options
                                if t.mapping == CENTRES_IN_LANES], b, m)
        if tile is not None:
            return tile
    points = [t for t in options if t.mapping == POINTS_IN_LANES]
    return (_widest_filling(points, b, m)
            or min(points, key=lambda t: t.centres))


class ExactTile(NamedTuple):
    """The tile of one exact-query call: the mapping, the centres and warps
    of a block, and the centres a lane holds (1 where lanes hold
    points)."""

    mapping: int
    centres: int
    warps: int
    per_lane: int


EXACT_POINTS = ExactTile(POINTS_IN_LANES, _EXACT_WARPS, _EXACT_WARPS, 1)


def exact_span(tile: ExactTile) -> int:
    """Points a round of a lanes-on-centres tile: a chunk a chunk group."""
    return tile.warps // (tile.centres // (32 * tile.per_lane)) * _ROW_CHUNK


def exact_smem_bytes(tile: ExactTile, nsample: int) -> int:
    """Shared memory of a block, as the launcher computes it: none where
    lanes hold points; else the copy's barrier, the copied round (up to 4
    values a point), the ring of squared rounds (16 bytes a point), the
    round's counts a chunk group, the hits so far and the slot table."""
    if tile.mapping == POINTS_IN_LANES:
        return 0
    span = exact_span(tile)
    chunk_groups = span // _ROW_CHUNK
    return (16 + 4 * span * 4 + _RING_STAGES * span * 16
            + 4 * (chunk_groups * tile.centres + tile.centres
                   + tile.centres * (nsample + 1)))


@functools.lru_cache(maxsize=None)
def exact_tiles(b: int, n: int, m: int, nsample: int,
                dtype: torch.dtype) -> tuple[ExactTile, ...]:
    """Every tile :func:`exact_plan` may pick for a (b, n, m, nsample)
    call computed in `dtype`, all inside the limits `bq_exact_launch`
    checks. Lanes on points always (a warp a centre, 8 a block). Lanes on
    centres in float32 alone (the kernel is not templated on float64):
    1, 2 or 4 centres a lane, one or two centre groups a block, as many
    chunk groups as make 8 warps (fewer where the row has fewer chunks);
    none wider than the
    centres of a row, none whose slot table does not fit beside the ring
    (which keeps lanes on points free of a slot limit), and none at
    nsample 1, where a centre's first hit ends its scan (lanes on points
    leave each centre there; a block of lanes on centres waits for its
    slowest)."""
    del b  # the tiles depend on a row's shape alone
    found = [EXACT_POINTS]
    if dtype == torch.float32 and nsample > 1:
        widest = min(max(32, _pow2_ceil(m)), _MAX_CENTRES)
        chunks = -(-n // _ROW_CHUNK)
        for per_lane in _PER_LANE:
            for groups in (1, 2):
                centres = 32 * per_lane * groups
                if centres > widest:
                    continue
                warps = groups * min(8 // groups, _pow2_floor(chunks))
                found.append(ExactTile(CENTRES_IN_LANES, centres, warps,
                                       per_lane))
    return tuple(t for t in found
                 if exact_smem_bytes(t, nsample) <= _MAX_SMEM)


@functools.lru_cache(maxsize=None)
def exact_plan(b: int, n: int, m: int, nsample: int,
               dtype: torch.dtype) -> ExactTile:
    """The tile of a (b, n, m, nsample) exact-query call computed in
    `dtype`.

    Lanes on centres wherever :func:`exact_tiles` offers them: 64 centres
    a block, 2 a lane, where that gives every SM a block, else 32 centres,
    1 a lane. Lanes on points elsewhere (float64, nsample 1, a slot table
    that does not fit). On an H100 every tile of lanes on centres at or
    under 64 centres beats lanes on points at the first layers' shapes,
    and the 32-centre tile ties or beats it at the small ones; 2 centres a
    lane save a tenth at the first layers, where each SM still gets a
    block (every tile's time at every path shape: ``chip_smoke.py``'s
    ``[exact query]``, PERF.md §6)."""
    tiles = exact_tiles(b, n, m, nsample, dtype)
    for centres, per_lane in ((64, 2), (32, 1)):
        for t in tiles:
            if (t.mapping == CENTRES_IN_LANES
                    and (t.centres, t.per_lane) == (centres, per_lane)
                    and (centres == 32
                         or blocks(t, b, m) >= _SMS)):
                return t
    return EXACT_POINTS


def exact_walked(idx: torch.Tensor, tile: ExactTile, n: int) -> int:
    """The distance tests a lanes-on-centres tile executes, from its own
    output `idx` (B, M, S), S > 1: each block walks whole rounds up to the
    one that holds the last S-th hit among its centres, or its whole row
    of `n` points where a centre has fewer than S hits (a centre has S
    hits iff slot S - 1 differs from slot 0), and tests each point walked
    against each of its centres."""
    if tile.mapping != CENTRES_IN_LANES or idx.shape[-1] < 2:
        raise ValueError("the walk is defined for lanes on centres at"
                         " nsample > 1")
    b, m, s = idx.shape
    full = idx[..., s - 1] != idx[..., 0]
    last = torch.where(full, idx[..., s - 1].long(), n - 1)
    blocks = -(-m // tile.centres)
    last = torch.nn.functional.pad(last, (0, blocks * tile.centres - m),
                                   value=-1)
    last = last.view(b, blocks, tile.centres).amax(-1)
    span = exact_span(tile)
    walked = torch.clamp((last // span + 1) * span, max=n)
    rows = torch.full((blocks,), tile.centres, dtype=torch.long,
                      device=idx.device)
    rows[-1] = m - (blocks - 1) * tile.centres
    return int((walked * rows).sum())


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


def _check_clouds(xyz, new_xyz):
    """What both kernels take: (B, *, 3) points and centres on one device
    with one batch."""
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be (B, *, 3), got"
                             f" {tuple(t.shape)}")
    if new_xyz.device != xyz.device or new_xyz.shape[0] != xyz.shape[0]:
        raise ValueError("xyz and new_xyz must share device and batch")


def _ball_query_stratified_cuda(xyz, new_xyz, radius, nsample,
                                tile: Plan | None = None, counter=None):
    """The kernel on CUDA tensors; `tile` overrides :func:`plan` (for
    checks and measurements of the other tiles), and `counter`, a one-
    element int64 CUDA tensor, has the distance tests executed added to
    it."""
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dtype != torch.float32:
            raise TypeError(f"ball query kernel takes float32 {name},"
                            f" got {t.dtype}")
    _check_clouds(xyz, new_xyz)
    if not 0 < nsample <= _MAX_SLOTS:
        raise ValueError(f"nsample must be in 1..{_MAX_SLOTS}, got"
                         f" {nsample}")
    xyz = xyz if xyz.stride(-1) == 1 else xyz.contiguous()
    new_xyz = new_xyz if new_xyz.stride(-1) == 1 else new_xyz.contiguous()
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if tile is None:
        tile = plan(b, n, m, nsample)
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=xyz.device)
    hit = torch.empty(b, m, nsample, dtype=torch.bool, device=xyz.device)
    err = KERNEL.lib.bq_stratified_launch(
        _build.ptr(xyz), xyz.stride(0), xyz.stride(1),
        _build.ptr(new_xyz), new_xyz.stride(0), new_xyz.stride(1),
        b, n, m, radius * radius, nsample, _bucket_size(n, nsample),
        *tile, _build.ptr(idx), _build.ptr(hit),
        None if counter is None else _build.ptr(counter),
        _build.stream_of(xyz))
    _build.check(err, "bq_stratified_launch")
    KERNEL.launches += 1
    KERNEL.bytes += _build.nbytes(xyz, new_xyz, idx, hit)
    return idx, hit


def _ball_query_exact_torch(xyz, new_xyz, radius, nsample,
                            chunk: int = _CHUNK):
    """The plain exact query (counterpart of the JAX ``ball_query``).

    Centres go `chunk` at a time (the last chunk padded) to bound the
    (B, chunk, N) distances. A hit's key 2n - j ranks above every miss's
    n - j, and within each group the key falls with the index j, so the
    top `nsample` keys are the first hits in index order; the keys are
    unique, so ties cannot arise. float64 inputs take the direct form
    |c - p|^2 (the expanded form's cancellation would flip points near
    the radius against the reference's direct test); others compute in
    float32 in the expanded form. r^2 is the Python product rounded once
    to that dtype."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    ct = torch.float64 if xyz.dtype == torch.float64 else torch.float32
    # made on the device: no copy from the host
    r2 = torch.full((), radius * radius, dtype=ct, device=xyz.device)
    xyz = xyz.to(ct)
    new_xyz = new_xyz.to(ct)
    chunk = min(chunk, m)
    m_pad = -(-m // chunk) * chunk
    if m_pad != m:
        pad = torch.zeros(b, m_pad - m, 3, dtype=ct, device=xyz.device)
        new_xyz = torch.cat([new_xyz, pad], dim=1)
    j = torch.arange(n, dtype=torch.int32, device=xyz.device)
    slot = torch.arange(nsample, device=xyz.device)
    outs = []
    for start in range(0, m_pad, chunk):
        centres = new_xyz[:, start:start + chunk]
        if ct == torch.float64:
            d2 = _sq3_sum(centres[:, :, None, :] - xyz[:, None, :, :])
        else:
            d2 = _pairwise_d2(centres, xyz)
        mask = d2 < r2
        key = torch.where(mask, 2 * n - j, n - j)
        idx = torch.topk(key, nsample, dim=-1).indices.to(torch.int32)
        cnt = mask.sum(dim=-1)
        outs.append(torch.where(slot < cnt[..., None], idx, idx[..., :1]))
    return torch.cat(outs, dim=1)[:, :m]


def _ball_query_exact_cuda(xyz, new_xyz, radius, nsample,
                           tile: ExactTile | None = None, counter=None):
    """The kernel on CUDA tensors, in float64 for float64 `xyz`, else in
    float32 (both inputs cast to it, as the plain version casts them);
    `tile` overrides :func:`exact_plan` (for checks and measurements of
    the other tiles; one the launcher refuses raises), and `counter`, a
    one-element int64 CUDA tensor, has the distance tests executed added
    to it."""
    ct = torch.float64 if xyz.dtype == torch.float64 else torch.float32
    _check_clouds(xyz, new_xyz)
    if nsample <= 0:
        raise ValueError(f"nsample must be positive, got {nsample}")
    xyz = xyz.to(ct)
    new_xyz = new_xyz.to(ct)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if tile is None:
        tile = exact_plan(b, n, m, nsample, ct)
    # the kernels read a row's points as whole 16-byte words: rows of 3
    # contiguous values, or 4 where lanes hold centres (SA1's xyz, the
    # first 3 of each point's 4 values, is read as it lies; lanes on points
    # take a copy)
    rows = (3,) if tile.mapping == POINTS_IN_LANES else (3, 4)
    if xyz.stride(-1) != 1 or xyz.stride(-2) not in rows:
        xyz = xyz.contiguous()
    new_xyz = new_xyz if new_xyz.stride(-1) == 1 else new_xyz.contiguous()
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=xyz.device)
    err = KERNEL.lib.bq_exact_launch(
        _build.ptr(xyz), xyz.stride(0), xyz.stride(1),
        _build.ptr(new_xyz), new_xyz.stride(0), new_xyz.stride(1),
        b, n, m, radius * radius, nsample, int(ct == torch.float64),
        *tile, _build.ptr(idx),
        None if counter is None else _build.ptr(counter),
        _build.stream_of(xyz))
    _build.check(err, "bq_exact_launch")
    EXACT.launches += 1
    EXACT.bytes += _build.nbytes(xyz, new_xyz, idx)
    return idx


def ball_query(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    radius: float,
    nsample: int,
    chunk: int = _CHUNK,
) -> torch.Tensor:
    """Exact reference ball query: the first `nsample` points in index
    order with squared distance < radius^2; slots past a centre's count
    repeat its first hit, and a centre with no hit gets index 0 in every
    slot. float64 inputs compute in float64, others in float32.

    Args:
      xyz: (B, N, 3) points.
      new_xyz: (B, M, 3) query centres.
      radius: ball radius.
      nsample: slots per centre.
      chunk: centres per distance block of the plain version; the kernel
        needs none and ignores it.

    Returns:
      (B, M, nsample) int32 indices into N, on the inputs' device. A CUDA
      tensor runs the kernel, a CPU tensor the plain version.
    """
    # integer-valued op: no gradient
    xyz = xyz.detach()
    new_xyz = new_xyz.detach()
    if xyz.is_cuda:
        return _ball_query_exact_cuda(xyz, new_xyz, radius, nsample)
    if xyz.device.type == "cpu":
        return _ball_query_exact_torch(xyz, new_xyz, radius, nsample, chunk)
    raise ValueError(f"no ball query for device {xyz.device}")


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
