"""The port's point-cloud ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both. On the CPU the
port's ops run their plain PyTorch versions (the CUDA kernels are held
against those on the card by chip_smoke.py). Tolerances: sampling and
neighbour indices must match exactly; floats to atol 1e-5 (f32 rounding
of a few-term sum).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu import ops as jops
from backtoreality_tpu.nn.sa_fp import _GroupMixin
from backtoreality_tpu_torch import ops as tops
from oracles import ball_query_stratified_oracle
from test_ops import make_cloud, safe_radius

jfps = importlib.import_module("backtoreality_tpu.ops.fps")
jbq = importlib.import_module("backtoreality_tpu.ops.ball_query")
tfps = importlib.import_module("backtoreality_tpu_torch.ops.fps")
tbq = importlib.import_module("backtoreality_tpu_torch.ops.ball_query")
tgroup = importlib.import_module("backtoreality_tpu_torch.ops.grouping")


def _boundary_free_radius(xyz, centers, r, margin=1e-5):
    """Smallest radius >= r with no centre-point squared distance within
    `margin` of r^2. The two expanded-form f32 computations round
    differently by about 1e-6 (XLA fuses them into FMAs under jit), so a
    point that close to the radius could fall either way."""
    d2 = np.sort(np.sum(
        (centers[:, :, None, :].astype(np.float64)
         - xyz[:, None, :, :].astype(np.float64)) ** 2, axis=-1).ravel())
    r2 = r * r
    while True:
        i = np.searchsorted(d2, r2 - margin)
        if i == d2.size or d2[i] >= r2 + margin:
            return float(np.sqrt(r2))
        r2 = d2[i] + 2 * margin


def _fps_cloud(seed, b, n):
    """Random cloud with a padded tail on row 0 and an all-padding last
    row."""
    xyz = make_cloud(np.random.default_rng(seed), b, n, pad_frac=0.0)
    xyz[0, n - n // 5:] = 0.0
    xyz[-1] = 0.0
    return xyz


def _field_key(v):
    """The CUDA kernel's packed key: a field value (>= 0, or -1) as an
    unsigned integer that orders the same way."""
    return np.float32(v).view(np.uint32) ^ np.uint32(0x80000000)


def _best(keys, idxs):
    """Largest key, then lowest index: what `__reduce_max_sync` and then
    `__reduce_min_sync` give a warp, and the scan of the slots a block."""
    top = keys.max()
    return top, idxs[keys == top].min()


def _fps_sharded(xyz, npoint, layout):
    """The CUDA kernel's reduction in numpy, one row: the row is split
    over `cluster` blocks of `threads` threads with `points` points each
    (thread t of block r owns r*T*P + p*T + t; indices past n behave as
    padding), every warp takes its best by the packed key, and the best
    of all warps' slots, with its coordinates, is the next sample."""
    cluster, threads, points = layout
    n = xyz.shape[0]
    total = cluster * threads * points
    assert total >= n
    pts = np.zeros((total, 3), np.float32)
    pts[:n] = xyz
    x, y, z = pts.T
    valid = (x * x + y * y) + z * z > np.float32(1e-3)
    mind = np.where(valid, np.float32(1e10), np.float32(-1))
    # owner[i]: the warp (slot) that holds index i
    i = np.arange(total)
    block, local = divmod(i, threads * points)
    slot = block * (threads // 32) + (local % threads) // 32
    out = np.zeros(npoint, np.int32)
    ref = pts[0]
    for j in range(1, npoint):
        dx, dy, dz = x - ref[0], y - ref[1], z - ref[2]
        mind = np.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        keys = _field_key(mind)
        slots = [_best(keys[slot == w], i[slot == w])
                 for w in range(slot.max() + 1)]
        _, out[j] = _best(np.array([k for k, _ in slots]),
                          np.array([ix for _, ix in slots]))
        ref = pts[out[j]]  # the slot carries the winner's coordinates
    return out


class TestFPS:
    @pytest.mark.parametrize("cluster", [1, 4, 16])
    def test_kernel_reduction_design(self, cluster):
        """Shards, warps and the packed key give `_fps_torch`'s samples
        one for one: n no multiple of the cluster, a padded tail, a shard
        of padding only, duplicated points (ties), an all-padding row."""
        n, npoint = 1000, 40
        layout = tfps.shard_plan(cluster, n)
        assert layout.cluster == cluster
        assert cluster * layout.threads * layout.points >= n
        assert layout.threads % 32 == 0 and layout.points in tfps._POINTS
        shard = layout.threads * layout.points
        rng = np.random.default_rng(cluster)
        xyz = make_cloud(rng, 4, n, pad_frac=0.0)
        xyz[0, n - n // 5:] = 0.0  # padded tail
        lo = min(shard, 64)
        xyz[1, lo:2 * lo] = 0.0  # a whole shard (or warp) of padding
        xyz[2] = xyz[2, np.arange(n) % 50]  # 20 copies of 50 points
        xyz[3] = 0.0  # all padding
        want = tfps._fps_torch(torch.from_numpy(xyz), npoint).numpy()
        for row in range(4):
            got = _fps_sharded(xyz[row], npoint, layout)
            np.testing.assert_array_equal(got, want[row])
        np.testing.assert_array_equal(want[3], 0)

    def test_packed_key_orders_as_keep_best(self):
        """key(a) > key(b), then the lower index, picks what 'larger
        value, then lower index' picks, for -1, 0, denormals and 1e10."""
        values = np.array([-1.0, 0.0, 1e-45, 1e-40, 1.1754944e-38, 1e-3,
                           1.0, 1e10], np.float32)
        keys = _field_key(values)
        assert keys.dtype == np.uint32
        assert (np.diff(keys.astype(np.int64)) > 0).all()  # same order
        pairs = [(v, i) for v in values for i in (0, 7, 123456)]
        for va, ia in pairs:
            for vb, ib in pairs:
                plain = va > vb or (va == vb and ia < ib)
                ka, kb = _field_key(va), _field_key(vb)
                packed = ka > kb or (ka == kb and ia < ib)
                assert plain == packed, (va, ia, vb, ib)

    def test_plan_rows_beyond_a_cluster_take_the_capacity_kernel(self):
        assert tfps.shard_plan(16, 16 * 512 * 16) is not None
        assert tfps.shard_plan(16, 16 * 512 * 16 + 1) is None
        assert tfps.shard_plan(1, 512) == tfps.Plan(1, 32, 16)  # one warp

    @pytest.mark.parametrize("b,n,m", [(3, 257, 33), (2, 1024, 256),
                                       (3, 2048, 512)])
    def test_plain_matches_xla(self, b, n, m):
        xyz = _fps_cloud(b * n, b, n)
        want = np.asarray(jfps._fps_xla(jnp.asarray(xyz), m))
        got = tfps._fps_torch(torch.from_numpy(xyz), m).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[-1], 0)  # all-padding row

    def test_plain_matches_pallas_interpret(self):
        xyz = _fps_cloud(1, 3, 257)
        want = np.asarray(jfps._fps_pallas(jnp.asarray(xyz), 33))
        got = tfps._fps_torch(torch.from_numpy(xyz), 33).numpy()
        np.testing.assert_array_equal(got, want)

    def test_candidates_prefix(self):
        xyz = make_cloud(np.random.default_rng(5), 2, 256, pad_frac=0.0)
        want = np.asarray(jops.furthest_point_sample(
            jnp.asarray(xyz), 16, candidates=64))
        got = tops.furthest_point_sample(torch.from_numpy(xyz), 16,
                                         candidates=64).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.max() < 64

    def test_cpu_tensor_takes_plain_version(self):
        before = tfps.KERNEL.launches
        xyz = torch.from_numpy(_fps_cloud(2, 2, 100))
        got = tops.furthest_point_sample(xyz, 8)
        assert got.dtype == torch.int32 and got.shape == (2, 8)
        assert tfps.KERNEL.launches == before

    def test_rejects_other_devices(self):
        xyz = torch.zeros(1, 16, 3, device="meta")
        with pytest.raises(ValueError):
            tops.furthest_point_sample(xyz, 4)
        with pytest.raises(ValueError):
            tops.ball_query_stratified(xyz, xyz, 0.5, 4)


class TestBallQueryStratified:
    # the Pallas kernel runs in interpret mode here, so it is checked on
    # the small cases only
    @pytest.mark.parametrize("n,m,r,s,pallas", [(200, 16, 0.9, 8, True),
                                                (256, 16, 0.9, 8, True),
                                                (1500, 200, 0.5, 16, False),
                                                (3000, 128, 0.3, 64, False)])
    def test_plain_matches_xla_and_pallas(self, n, m, r, s, pallas):
        rng = np.random.default_rng(n)
        xyz = make_cloud(rng, 2, n, pad_frac=0.0, scale=1.5)
        centers = xyz[:, :m].copy()
        centers[0, 0] = 50.0  # a centre with no neighbour at all
        r = _boundary_free_radius(xyz, centers, r)
        want_i, want_h = jbq._ball_query_stratified_xla(
            jnp.asarray(xyz), jnp.asarray(centers), r, s)
        got_i, got_h = tops.ball_query_stratified(
            torch.from_numpy(xyz), torch.from_numpy(centers), r, s,
            return_hit=True)
        assert got_i.dtype == torch.int32 and got_h.dtype == torch.bool
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
        np.testing.assert_array_equal(got_i[0, 0].numpy(), 0)
        if pallas:
            pl_i, pl_h = jbq._ball_query_stratified_pallas(
                jnp.asarray(xyz), jnp.asarray(centers), r, s, 16)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(pl_i))
            np.testing.assert_array_equal(got_h.numpy(), np.asarray(pl_h))

    @pytest.mark.parametrize("n,s", [(40000, 64), (2048, 32), (1024, 16),
                                     (512, 16), (100, 8)])
    def test_bucket_size_matches(self, n, s):
        assert tbq._bucket_size(n, s) == jbq._bucket_size(n, s)


def _bq_edge_case(name):
    """(xyz, centres, radius, nsample) of the edge inputs the CUDA kernel's
    tiles are held on: what a tiling can get wrong."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def cloud(b, n):
        return (rng.random((b, n, 3)) * 2.0).astype(np.float32)

    if name == "m33":  # 8 live buckets of 16, the last of 104 points
        xyz = cloud(2, 1000)
        return xyz, xyz[:, :33].copy(), 0.3, 16
    if name == "m257_s64":  # 24 live buckets of 64, the last of 56 points
        xyz = cloud(2, 3000)
        return xyz, xyz[:, 5:262].copy(), 0.25, 64
    if name == "n100_s1":  # below one bucket, one slot
        xyz = cloud(3, 100)
        return xyz, xyz[:, :40].copy(), 0.5, 1
    if name == "n100_s16":
        xyz = cloud(3, 100)
        return xyz, xyz[:, 30:70].copy(), 0.5, 16
    if name == "lonely_last":
        # centre 0 far from every point; centre 1's only hit is the last
        # point of the last live bucket
        xyz = cloud(2, 1500)
        xyz[:, -1] = 50.0
        centers = xyz[:, :64].copy()
        centers[:, 0] = 100.0
        centers[:, 1] = 50.01
        return xyz, centers, 0.4, 16
    if name == "duplicates":  # 64 points, each 32 times
        xyz = cloud(2, 64)[:, np.arange(2048) % 64]
        return xyz, xyz[:, :128].copy(), 0.5, 32
    if name == "b1_s64":
        xyz = cloud(1, 5000)
        return xyz, xyz[:, :600].copy(), 0.2, 64
    if name == "strided":  # a slice of a wider array
        wide = (rng.random((2, 2048, 5)) * 2.0).astype(np.float32)
        return wide[..., 1:4], wide[:, :300, 1:4], 0.3, 32
    raise KeyError(name)


_BQ_EDGE_CASES = ["m33", "m257_s64", "n100_s1", "n100_s16", "lonely_last",
                  "duplicates", "b1_s64", "strided"]
# (B, N, M, nsample) of the five set-abstraction calls of VoteNet at B=8,
# N=40000, and of the edge inputs above
_BQ_MAIN_SHAPES = [(8, 40000, 2048, 64), (8, 2048, 1024, 32),
                   (8, 1024, 512, 16), (8, 512, 256, 16),
                   (8, 1024, 256, 16)]
_BQ_EDGE_SHAPES = [(2, 1000, 33, 16), (2, 3000, 257, 64), (3, 100, 40, 1),
                   (3, 100, 40, 16), (2, 1500, 64, 16), (2, 2048, 128, 32),
                   (1, 5000, 600, 64), (2, 2048, 300, 32)]


class TestBallQueryEdges:
    """The plain version on the inputs the CUDA tiles are checked on,
    against the XLA implementation and the numpy oracle, bit for bit."""

    @pytest.mark.parametrize("name", _BQ_EDGE_CASES)
    def test_plain_matches_xla_and_oracle(self, name):
        xyz, centers, r, s = _bq_edge_case(name)
        r = _boundary_free_radius(xyz, centers, r)
        want_i, want_h = jbq._ball_query_stratified_xla(
            jnp.asarray(xyz), jnp.asarray(centers), r, s)
        txyz, tcenters = torch.from_numpy(xyz), torch.from_numpy(centers)
        if name == "strided":
            assert not txyz.is_contiguous()
        got_i, got_h = tops.ball_query_stratified(txyz, tcenters, r, s,
                                                  return_hit=True)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
        np.testing.assert_array_equal(
            got_i.numpy(), ball_query_stratified_oracle(xyz, centers, r, s))
        if name == "lonely_last":
            n = xyz.shape[1]
            last = (n - 1) // tbq._bucket_size(n, s)
            assert not got_h[:, 0].any() and (got_i[:, 0] == 0).all()
            assert got_h[:, 1].nonzero()[:, 1].tolist() == [last, last]
            assert (got_i[:, 1] == n - 1).all()


class TestBallQueryPlan:
    """`ops.ball_query.plan`: the tile of the CUDA kernel as a plain
    function of the shape."""

    @pytest.mark.parametrize("b,n,m,s", _BQ_MAIN_SHAPES + _BQ_EDGE_SHAPES)
    def test_tiles_are_inside_the_kernel_limits(self, b, n, m, s):
        tiles = tbq.tiles(b, n, m, s)
        chosen = tbq.plan(b, n, m, s)
        assert chosen in tiles
        assert {t.mapping for t in tiles} == {tbq.CENTRES_IN_LANES,
                                              tbq.POINTS_IN_LANES}
        live = -(-n // tbq._bucket_size(n, s))
        for t in tiles:
            assert 1 <= t.warps <= tbq._MAX_WARPS
            assert 1 <= t.centres <= tbq._MAX_CENTRES
            assert tbq.smem_bytes(t, s) <= tbq._MAX_SMEM
            if t.mapping == tbq.CENTRES_IN_LANES:
                assert t.per_lane in tbq._PER_LANE
                assert t.centres % (32 * t.per_lane) == 0
                groups = t.centres // (32 * t.per_lane)
                assert t.warps % groups == 0
                assert t.warps // groups <= live  # no idle bucket group
            else:
                assert t.centres <= tbq._MAX_POINT_CENTRES
                assert t.per_lane == 1 and t.warps <= live
        # every SM gets a block where the centres allow it at all
        most = max(tbq.blocks(t, b, m) for t in tiles)
        assert tbq.blocks(chosen, b, m) >= min(tbq._SMS, most)

    @pytest.mark.parametrize("b,n,m,s", _BQ_MAIN_SHAPES)
    def test_main_path_shapes_fill_the_card(self, b, n, m, s):
        tile = tbq.plan(b, n, m, s)
        assert tbq.blocks(tile, b, m) >= tbq._SMS
        # lanes on centres only where a bucket is one chunk and a row has
        # the work for it: the second layer's call
        lanes_on_centres = (b, n, m, s) == (8, 2048, 1024, 32)
        assert (tile.mapping == tbq.CENTRES_IN_LANES) == lanes_on_centres

    def test_smem_matches_the_launcher(self):
        """`smem_bytes` is the launcher's sum: the table of first hits and
        fills, and two staged chunks per bucket group or the centres."""
        lanes = tbq.Plan(tbq.CENTRES_IN_LANES, 128, 8, 2)  # 2 x 4 groups
        assert tbq.smem_bytes(lanes, 64) == (
            4 * (128 * 65 + 128) + 4 * 2 * 3 * 128 * 4)
        points = tbq.Plan(tbq.POINTS_IN_LANES, 32, 8, 1)
        assert tbq.smem_bytes(points, 16) == 4 * (32 * 17 + 32) + 16 * 32


class TestGroupingInterpolate:
    def test_gather_points(self):
        rng = np.random.default_rng(8)
        pts = rng.random((2, 10, 5)).astype(np.float32)
        idx = rng.integers(0, 10, (2, 4)).astype(np.int32)
        want = np.asarray(jops.gather_points(jnp.asarray(pts),
                                             jnp.asarray(idx)))
        got = tops.gather_points(torch.from_numpy(pts),
                                 torch.from_numpy(idx)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("radius_frac", [0.9, 0.25])
    def test_group_points_stratified(self, radius_frac):
        rng = np.random.default_rng(11)
        xyz = make_cloud(rng, 2, 300, pad_frac=0.0, scale=1.5)
        centers = xyz[:, :24].copy()
        centers[0, 0] = 50.0
        r = safe_radius(xyz, centers, radius_frac)
        feats = rng.random((2, 300, 7)).astype(np.float32)
        idx, hit = jops.ball_query_stratified(
            jnp.asarray(xyz), jnp.asarray(centers), r, 8, return_hit=True)
        want = np.asarray(jops.group_points_stratified(
            jnp.asarray(feats), idx, hit))
        got = tops.group_points_stratified(
            torch.from_numpy(feats), torch.from_numpy(np.array(idx)),
            torch.from_numpy(np.array(hit))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_three_nn(self):
        rng = np.random.default_rng(5)
        unknown = make_cloud(rng, 2, 200, pad_frac=0.0)
        known = make_cloud(rng, 2, 64, pad_frac=0.0)
        dist, idx = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
        tdist, tidx = tops.three_nn(torch.from_numpy(unknown),
                                    torch.from_numpy(known))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
        np.testing.assert_allclose(tdist.numpy(), np.asarray(dist),
                                   rtol=0, atol=1e-5)

    def test_three_interpolate(self):
        rng = np.random.default_rng(6)
        feats = rng.random((2, 20, 7)).astype(np.float32)
        idx = rng.integers(0, 20, (2, 30, 3)).astype(np.int32)
        w = rng.random((2, 30, 3)).astype(np.float32)
        want = np.asarray(jops.three_interpolate(
            jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w)))
        got = tops.three_interpolate(torch.from_numpy(feats),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _stratified_case(seed, n, m, s, radius_frac, c, lonely=(0, 0)):
    """Cloud, features and the JAX stratified ball query's (idx, hit),
    with one centre, `lonely` = (batch row, centre), that has no neighbour
    at all."""
    rng = np.random.default_rng(seed)
    xyz = make_cloud(rng, 2, n, pad_frac=0.0, scale=1.5)
    centers = xyz[:, :m].copy()
    centers[lonely] = 50.0
    r = safe_radius(xyz, centers, radius_frac)
    feats = rng.normal(size=(2, n, c)).astype(np.float32)
    idx, hit = jops.ball_query_stratified(
        jnp.asarray(xyz), jnp.asarray(centers), r, s, return_hit=True)
    gout = rng.normal(size=(2, m, s, c)).astype(np.float32)
    assert not np.array(hit)[lonely].any()
    return feats, np.array(idx), np.array(hit), gout


def _backward_lists(idx, hit, n, bucket):
    """Pass 1 of the CUDA kernel's backward in numpy: per (batch row, live
    stratum t) a CSR over the stratum's points. An entry is (centre,
    is_fold): the centre's grad_out row at slot t if the slot is a hit,
    and its fold row if slot t is its first hit (slot 0 for a centre with
    no hit). Entries of a point are in increasing centre, a centre's
    grad_out row before its fold row."""
    b, m, s = idx.shape
    live = -(-n // bucket)
    assert live <= s
    starts = np.zeros((b, live, bucket + 1), np.int64)
    lists = [[None] * live for _ in range(b)]
    for bi in range(b):
        any_hit = hit[bi].any(-1)
        first = np.where(any_hit, hit[bi].argmax(-1), 0)
        for t in range(live):
            keyed = []  # (offset in the stratum, 2 * centre + is_fold)
            for mi in range(m):
                k = idx[bi, mi, t] - t * bucket
                if hit[bi, mi, t] or first[mi] == t:
                    assert 0 <= k < min(bucket, n - t * bucket)
                if hit[bi, mi, t]:
                    keyed.append((k, 2 * mi))
                if first[mi] == t:
                    keyed.append((k, 2 * mi + 1))
            keyed.sort()
            counts = np.bincount([k for k, _ in keyed], minlength=bucket)
            starts[bi, t, 1:] = np.cumsum(counts)
            lists[bi][t] = [(key // 2, key % 2) for _, key in keyed]
    return starts, lists


def _three_pass_backward(gout, idx, hit, n, bucket):
    """The CUDA kernel's backward design in numpy (the lists built once,
    whatever the channels; the slot-filled slots folded per centre in slot
    order; each point's list summed in list order), to hold the design
    itself against the scatter-add on the CPU."""
    b, m, s, c = gout.shape
    starts, lists = _backward_lists(idx, hit, n, bucket)
    fold = np.zeros((b, m, c), np.float64)
    for bi in range(b):
        for mi in range(m):
            for t in range(s):  # slot order
                if not hit[bi, mi, t]:
                    fold[bi, mi] += gout[bi, mi, t]
    grad = np.zeros((b, n, c), np.float64)
    for bi in range(b):
        for p in range(n):  # every point is written
            t, k = divmod(p, bucket)
            entries = lists[bi][t][starts[bi, t, k]:starts[bi, t, k + 1]]
            assert entries == sorted(entries)
            for mi, is_fold in entries:
                grad[bi, p] += fold[bi, mi] if is_fold else gout[bi, mi, t]
    return grad


class TestGroupStratified:
    """K4's plain version (`_group_points_stratified_torch`) against the
    JAX `group_points_stratified`, through the Pallas kernel in
    interpret mode and through the one-hot einsum."""

    @pytest.mark.parametrize("use_pallas", [True, False])
    @pytest.mark.parametrize("radius_frac", [0.9, 0.25])
    def test_plain_equals_jax(self, use_pallas, radius_frac):
        feats, idx, hit, _ = _stratified_case(11, 300, 24, 8, radius_frac,
                                              7)
        want = np.asarray(jops.group_points_stratified(
            jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(hit),
            use_pallas=use_pallas))
        got = tgroup._group_points_stratified_torch(
            torch.from_numpy(feats), torch.from_numpy(idx),
            torch.from_numpy(hit)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("use_pallas", [True, False])
    def test_gradient_matches_jax_vjp(self, use_pallas):
        feats, idx, hit, gout = _stratified_case(12, 300, 24, 8, 0.6, 5)
        _, vjp = jax.vjp(lambda p: jops.group_points_stratified(
            p, jnp.asarray(idx), jnp.asarray(hit), use_pallas=use_pallas),
            jnp.asarray(feats))
        (want,) = vjp(jnp.asarray(gout))
        p = torch.from_numpy(feats).requires_grad_()
        out = tops.group_points_stratified(p, torch.from_numpy(idx),
                                           torch.from_numpy(hit))
        (got,) = torch.autograd.grad(out, p, torch.from_numpy(gout))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)

    @pytest.mark.parametrize("n,m,s,radius_frac,lonely",
                             [(300, 24, 8, 0.9, (0, 0)),
                              (300, 24, 8, 0.25, (0, 0)),
                              (700, 40, 16, 0.5, (0, 0)),
                              (300, 24, 8, 0.5, (1, 5))])
    def test_kernel_backward_design(self, n, m, s, radius_frac, lonely):
        feats, idx, hit, gout = _stratified_case(n + s, n, m, s,
                                                 radius_frac, 3, lonely)
        bucket = tbq._bucket_size(n, s)
        assert -(-n // bucket) < s  # fewer live strata than slots
        want = np.zeros((2, n, 3))
        for bi in range(2):
            np.add.at(want[bi], idx[bi].reshape(-1),
                      gout[bi].reshape(-1, 3).astype(np.float64))
        got = _three_pass_backward(gout, idx, hit, n, bucket)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    def test_cpu_tensor_takes_plain_version(self):
        feats, idx, hit, _ = _stratified_case(13, 200, 16, 8, 0.5, 4)
        before = (tgroup.KERNEL.launches, tgroup.KERNEL.backward_launches)
        p = torch.from_numpy(feats).requires_grad_()
        tops.group_points_stratified(p, torch.from_numpy(idx),
                                     torch.from_numpy(hit)).sum().backward()
        assert p.grad.shape == p.shape
        assert (tgroup.KERNEL.launches,
                tgroup.KERNEL.backward_launches) == before

    def test_rejects_other_devices(self):
        pts = torch.zeros(1, 16, 4, device="meta")
        idx = torch.zeros(1, 4, 2, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            tops.group_points_stratified(pts, idx, idx.bool())


class TestChamfer:
    @pytest.mark.parametrize("mode", ["sq", "l1", "l1smooth"])
    def test_nn_distance_matches_jax(self, mode):
        rng = np.random.default_rng(21)
        pc1 = (rng.normal(size=(3, 40, 3)) * 1.5).astype(np.float32)
        pc2 = (rng.normal(size=(3, 17, 3)) * 1.5).astype(np.float32)
        kw = dict(l1=mode == "l1", l1smooth=mode == "l1smooth")
        want = jops.nn_distance(jnp.asarray(pc1), jnp.asarray(pc2), **kw)
        got = tops.nn_distance(torch.from_numpy(pc1),
                               torch.from_numpy(pc2), **kw)
        for g, w in zip(got, want):
            w = np.asarray(w)
            if w.dtype.kind in "iu":
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)

    def test_argmin_ties_take_lowest_index(self):
        pc1 = torch.zeros(1, 1, 3)
        pc2 = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]])
        _, idx1, _, idx2 = tops.nn_distance(pc1, pc2)
        assert idx1.tolist() == [[0]] and idx2.tolist() == [[0, 0, 0]]

    def test_huber_loss_matches_jax(self):
        err = np.random.default_rng(22).normal(size=(50,)).astype(
            np.float32) * 2
        for delta in (1.0, 0.5):
            want = np.asarray(jops.huber_loss(jnp.asarray(err), delta))
            got = tops.huber_loss(torch.from_numpy(err), delta).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class _JaxGroup(_GroupMixin):
    """The JAX set-abstraction layer's `_group` with VoteNet's settings."""

    query_mode = "stratified"
    normalize_xyz = True
    use_xyz = True

    def __init__(self, radius, nsample):
        self.radius = radius
        self.nsample = nsample


def _localize_case(seed, with_features):
    rng = np.random.default_rng(seed)
    xyz = make_cloud(rng, 2, 400, pad_frac=0.0, scale=1.5)
    centers = xyz[:, :24].copy() + rng.normal(size=(2, 24, 3)).astype(
        np.float32) * 0.01
    centers[0, 0] = 50.0  # no neighbour at all
    r = _boundary_free_radius(xyz, centers, 0.7)
    feats = (rng.normal(size=(2, 400, 6)).astype(np.float32)
             if with_features else None)
    return xyz, feats, centers, r, 8


class TestGroupLocalize:
    """`group_localize_stratified` (its plain version) against the JAX
    layer's ball query -> stratified grouping -> subtract, divide,
    concatenate."""

    @pytest.mark.parametrize("with_features", [True, False])
    def test_forward_equals_jax_f32(self, with_features):
        """A gather, one subtraction and one division: tolerance 0."""
        xyz, feats, centers, r, s = _localize_case(31, with_features)
        want, want_local = _JaxGroup(r, s)._group(
            jnp.asarray(xyz), jnp.asarray(centers),
            None if feats is None else jnp.asarray(feats))
        txyz, tcenters = torch.from_numpy(xyz), torch.from_numpy(centers)
        idx, hit = tops.ball_query_stratified(txyz, tcenters, r, s,
                                              return_hit=True)
        assert not hit[0, 0].any()
        got = tops.group_localize_stratified(
            txyz, None if feats is None else torch.from_numpy(feats),
            tcenters, idx, hit, r)
        assert got.shape == (2, 24, s, 3 + (6 if with_features else 0))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[..., :3].numpy(),
                                      np.asarray(want_local))

    @pytest.mark.parametrize("with_features", [True, False])
    def test_gradients_match_jax_f64(self, with_features):
        """Gradients of xyz, features and the centres against `jax.grad`
        in float64, atol 1e-12."""
        xyz, feats, centers, r, s = _localize_case(32, with_features)
        c = 3 + (6 if with_features else 0)
        gout = np.random.default_rng(33).normal(size=(2, 24, s, c))
        names = ["xyz", "centers"] + (["feats"] if with_features else [])
        args = {"xyz": xyz, "centers": centers, "feats": feats}
        jax.config.update("jax_enable_x64", True)
        try:
            def loss(d):
                grouped, _ = _JaxGroup(r, s)._group(
                    d["xyz"], d["centers"], d.get("feats"))
                return jnp.sum(grouped * jnp.asarray(gout))
            want = jax.device_get(jax.grad(loss)(
                {k: jnp.asarray(args[k], jnp.float64) for k in names}))
        finally:
            jax.config.update("jax_enable_x64", False)
        leaves = {k: torch.from_numpy(args[k]).double().requires_grad_()
                  for k in names}
        idx, hit = tops.ball_query_stratified(
            leaves["xyz"], leaves["centers"], r, s, return_hit=True)
        out = tops.group_localize_stratified(
            leaves["xyz"], leaves.get("feats"), leaves["centers"], idx, hit,
            r)
        got = torch.autograd.grad(out, [leaves[k] for k in names],
                                  torch.from_numpy(gout))
        for k, g in zip(names, got):
            assert np.abs(want[k]).max() > 0, k
            np.testing.assert_allclose(g.numpy(), want[k], rtol=0,
                                       atol=1e-12, err_msg=k)

    def test_cpu_tensor_takes_plain_version(self):
        xyz, feats, centers, r, s = _localize_case(34, True)
        before = (tgroup.KERNEL.launches, tgroup.LOCALIZE.launches,
                  tgroup.LOCALIZE.backward_launches)
        leaves = [torch.from_numpy(a).requires_grad_()
                  for a in (xyz, feats, centers)]
        idx, hit = tops.ball_query_stratified(leaves[0], leaves[2], r, s,
                                              return_hit=True)
        tops.group_localize_stratified(leaves[0], leaves[1], leaves[2], idx,
                                       hit, r).sum().backward()
        assert all(a.grad is not None for a in leaves)
        assert (tgroup.KERNEL.launches, tgroup.LOCALIZE.launches,
                tgroup.LOCALIZE.backward_launches) == before

    def test_rejects_other_devices(self):
        xyz = torch.zeros(1, 16, 3, device="meta")
        idx = torch.zeros(1, 4, 2, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            tops.group_localize_stratified(xyz, None, xyz[:, :4], idx,
                                           idx.bool(), 0.5)
