"""The port's FSB criterion against the JAX package's, on the CPU.

`get_loss` runs on one fixed labelled batch (the synthetic-scan pipeline)
and fixed end_points made with numpy from a seed, in float64 on both
sides (JAX with x64 on). The port keeps the JAX package's float32 casts
(class weights, masks, one-hots, `mean_size_arr`), so the two agree to
rounding: the loss and every aux scalar to rtol 1e-9, the integer aux
tensors exactly, and the gradient with respect to every float end_points
entry to atol 1e-9. The loss primitives of `losses/common.py` are held
against their JAX counterparts in float32 (rtol 1e-6: a few-term sum).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.data.dataset import DetectionDataset
from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.losses import common as jcommon
from backtoreality_tpu.losses import votenet as jlosses
from backtoreality_tpu_torch.data import scannet_md40_config
from backtoreality_tpu_torch.losses import common as tcommon
from backtoreality_tpu_torch.losses import votenet as tlosses

B, N, NUM_SEED, K = 2, 1000, 64, 32
FLOAT_KEYS = ("seed_xyz", "vote_xyz", "aggregated_vote_xyz",
              "objectness_scores", "center", "heading_scores",
              "heading_residuals_normalized", "size_scores",
              "size_residuals_normalized", "sem_cls_scores")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Labelled batch + end_points (numpy, float64 for the floats)."""
    d = tmp_path_factory.mktemp("torch_loss_scans")
    write_synthetic_scans(d, jax_config(), num_scans=B, num_objects=4,
                          points_per_object=200, floor_points=300, seed=1)
    ds = DetectionDataset(jax_config(), d, split="all", num_points=N)
    items = [ds.get(i) for i in range(B)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    cfg = scannet_md40_config()
    nh, ns, nc = cfg.num_heading_bin, cfg.num_size_cluster, cfg.num_class
    rng = np.random.default_rng(0)
    seed_inds = rng.integers(0, N, (B, NUM_SEED)).astype(np.int32)
    seed_xyz = np.take_along_axis(batch["point_clouds"][..., :3],
                                  seed_inds[..., None], 1).astype(np.float64)
    gt = batch["center_label"][:, rng.integers(0, 4, K)].astype(np.float64)
    agg = gt + rng.normal(0, 0.4, (B, K, 3))
    ep = {
        "seed_inds": seed_inds,
        "seed_xyz": seed_xyz,
        "vote_xyz": seed_xyz + rng.normal(0, 0.3, seed_xyz.shape),
        "aggregated_vote_xyz": agg,
        "objectness_scores": rng.normal(size=(B, K, 2)),
        "center": agg + rng.normal(0, 0.1, (B, K, 3)),
        "heading_scores": rng.normal(size=(B, K, nh)),
        "heading_residuals_normalized": rng.normal(0, 0.3, (B, K, nh)),
        "size_scores": rng.normal(size=(B, K, ns)),
        "size_residuals_normalized": rng.normal(0, 0.3, (B, K, ns, 3)),
        "sem_cls_scores": rng.normal(size=(B, K, nc)),
    }
    for key, v in batch.items():
        ep[key] = v.astype(np.float64) if v.dtype == np.float32 else v
    return cfg, ep


def _jax_loss(ep, cfg):
    """(loss, aux, grads w.r.t. FLOAT_KEYS) of the JAX criterion, x64."""
    jax.config.update("jax_enable_x64", True)
    try:
        fixed = {k: jnp.asarray(v) for k, v in ep.items()
                 if k not in FLOAT_KEYS}

        def fn(floats):
            return jlosses.get_loss({**fixed, **floats}, cfg)

        floats = {k: jnp.asarray(ep[k], jnp.float64) for k in FLOAT_KEYS}
        (loss, aux), grads = jax.value_and_grad(fn, has_aux=True)(floats)
        return jax.device_get((loss, aux, grads))
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_loss(ep, cfg):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in ep.items()}
    for k in FLOAT_KEYS:
        t[k].requires_grad_()
    loss, aux = tlosses.get_loss(t, cfg)
    # aggregated_vote_xyz only sets the (discrete) objectness labels
    grads = torch.autograd.grad(loss, [t[k] for k in FLOAT_KEYS],
                                allow_unused=True, materialize_grads=True)
    return loss, aux, dict(zip(FLOAT_KEYS, grads))


def test_get_loss_matches_jax_f64(case):
    cfg, ep = case
    want_loss, want_aux, _ = _jax_loss(ep, cfg)
    loss, aux, _ = _port_loss(ep, cfg)
    assert set(aux) == set(want_aux)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-9)
    for key, want in want_aux.items():
        want = np.asarray(want)
        got = aux[key].detach().numpy()
        assert got.dtype == want.dtype, key
        if want.ndim == 0:
            np.testing.assert_allclose(got, want, rtol=1e-9, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    # the fixture must exercise both sides of the objectness thresholds
    assert 0 < aux["pos_ratio"].item() < 1
    assert aux["neg_ratio"].item() > 0


def test_get_loss_gradients_match_jax_f64(case):
    cfg, ep = case
    _, _, want = _jax_loss(ep, cfg)
    _, _, got = _port_loss(ep, cfg)
    for key in FLOAT_KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-9, err_msg=key)
    # zero by construction: aggregated_vote_xyz only sets the discrete
    # labels, and ScanNet has one heading bin (a one-class softmax)
    nonzero = {k for k in FLOAT_KEYS if np.abs(np.asarray(want[k])).max()}
    assert nonzero == set(FLOAT_KEYS) - {"aggregated_vote_xyz",
                                         "heading_scores"}


def _logits_labels(seed, c=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(3, 11, c)).astype(np.float32) * 2
    labels = rng.integers(0, c, (3, 11)).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("weights", [None, (0.2, 0.3, 0.1, 0.25, 0.15)])
def test_softmax_ce(weights):
    logits, labels = _logits_labels(1)
    want = jcommon.softmax_ce(jnp.asarray(logits), jnp.asarray(labels),
                              weights)
    got = tcommon.softmax_ce(torch.from_numpy(logits),
                             torch.from_numpy(labels), weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_masked_mean():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 9)).astype(np.float32)
    mask = (rng.random((4, 9)) > 0.4).astype(np.int32)
    want = jcommon.masked_mean(jnp.asarray(x), jnp.asarray(mask))
    got = tcommon.masked_mean(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    zero = tcommon.masked_mean(torch.from_numpy(x), torch.zeros(4, 9))
    assert zero.item() == 0.0


def test_sigmoid_bce_with_logits():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(50,)) * 4).astype(np.float32)
    targets = (rng.random(50) > 0.5).astype(np.float32)
    want = jcommon.sigmoid_bce_with_logits(jnp.asarray(logits),
                                           jnp.asarray(targets))
    got = tcommon.sigmoid_bce_with_logits(torch.from_numpy(logits),
                                          torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_softmax_focal_loss():
    logits, labels = _logits_labels(4)
    want = jcommon.softmax_focal_loss(jnp.asarray(logits),
                                      jnp.asarray(labels))
    got = tcommon.softmax_focal_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_one_hot_f32():
    labels = np.array([[0, 3, 1], [2, 2, 5]], np.int32)
    want = np.asarray(jcommon.one_hot_f32(jnp.asarray(labels), 4))
    got = tcommon.one_hot_f32(torch.from_numpy(labels), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
