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
from backtoreality_tpu_torch import ops as tops
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


class TestFPS:
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


def _stratified_case(seed, n, m, s, radius_frac, c):
    """Cloud, features and the JAX stratified ball query's (idx, hit),
    with one centre that has no neighbour at all."""
    rng = np.random.default_rng(seed)
    xyz = make_cloud(rng, 2, n, pad_frac=0.0, scale=1.5)
    centers = xyz[:, :m].copy()
    centers[0, 0] = 50.0
    r = safe_radius(xyz, centers, radius_frac)
    feats = rng.normal(size=(2, n, c)).astype(np.float32)
    idx, hit = jops.ball_query_stratified(
        jnp.asarray(xyz), jnp.asarray(centers), r, s, return_hit=True)
    gout = rng.normal(size=(2, m, s, c)).astype(np.float32)
    return feats, np.array(idx), np.array(hit), gout


def _two_pass_backward(gout, idx, hit, n, bucket):
    """The CUDA kernel's backward design in numpy (fold the slot-filled
    slots into the first-hit slot's row, then reduce each stratum over
    its centres in order), to hold the design itself against the
    scatter-add on the CPU."""
    b, m, s, c = gout.shape
    grad = np.zeros((b, n, c), np.float64)
    for bi in range(b):
        for mi in range(m):
            h = hit[bi, mi]
            first = int(np.argmax(h)) if h.any() else 0
            fold = gout[bi, mi][~h].astype(np.float64).sum(0)
            for t in range(s):
                if h[t] or t == first:
                    k = idx[bi, mi, t]
                    assert t * bucket <= k < (t + 1) * bucket
                    grad[bi, k] += (gout[bi, mi, t] if h[t] else 0.0) + (
                        fold if t == first else 0.0)
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

    @pytest.mark.parametrize("n,m,s,radius_frac",
                             [(300, 24, 8, 0.9), (300, 24, 8, 0.25),
                              (700, 40, 16, 0.5)])
    def test_kernel_backward_design(self, n, m, s, radius_frac):
        feats, idx, hit, gout = _stratified_case(n + s, n, m, s,
                                                 radius_frac, 3)
        want = np.zeros((2, n, 3))
        for bi in range(2):
            np.add.at(want[bi], idx[bi].reshape(-1),
                      gout[bi].reshape(-1, 3).astype(np.float64))
        got = _two_pass_backward(gout, idx, hit, n,
                                 tbq._bucket_size(n, s))
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
