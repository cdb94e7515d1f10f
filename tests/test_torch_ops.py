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

import jax.numpy as jnp

from backtoreality_tpu import ops as jops
from backtoreality_tpu_torch import ops as tops
from test_ops import make_cloud, safe_radius

jfps = importlib.import_module("backtoreality_tpu.ops.fps")
jbq = importlib.import_module("backtoreality_tpu.ops.ball_query")
tfps = importlib.import_module("backtoreality_tpu_torch.ops.fps")
tbq = importlib.import_module("backtoreality_tpu_torch.ops.ball_query")


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
