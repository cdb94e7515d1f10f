"""The port's VoteNet against the JAX package's, weights bridged.

Both models run in eval mode on the same numpy cloud (B=2, N=4096, a
height feature) with the JAX init carried over by
``bridge.state_dict_from_jax``.

* float32: the backbone's set-abstraction outputs must match (indices
  exactly, features to atol 1e-4). The feature-propagation layers and
  everything after them are not compared in f32: each FP layer
  interpolates onto points that coincide with known points (sa3 is an
  FPS subset of sa2), where the expanded-form squared distance is pure
  rounding residue and its inverse-distance weight ~1/sqrt(1e-6); the
  JAX package fuses that sum into FMAs under jit, so the two frameworks'
  residues differ and the weights with them (about 4e-3 on fp2).
* float64 (JAX with x64 on, the port's model in double): every
  end_points entry must match — indices exactly, floats to atol 1e-9.
  The stratified ball query runs in f32 in both packages, on identical
  coordinates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu.data import scannet_md40_config
from backtoreality_tpu.models.votenet import VoteNet as JaxVoteNet
from backtoreality_tpu.nn import BatchNorm as JaxBatchNorm
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.models.votenet import VoteNet
from backtoreality_tpu_torch.nn import BatchNorm

B, N = 2, 4096


@pytest.fixture(scope="module")
def setup():
    cfg = scannet_md40_config()
    kw = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
              num_size_cluster=cfg.num_size_cluster, input_feature_dim=1)
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    rng = np.random.default_rng(0)
    xyz = (rng.random((B, N, 3)) * 2 - 1) * [3.0, 3.0, 1.0] + [0, 0, 1.0]
    pc = np.concatenate([xyz, rng.random((B, N, 1))], -1).astype(
        np.float32)
    jax_model = JaxVoteNet(mean_size_arr=msa, **kw)
    variables = jax.device_get(jax.jit(
        lambda k, x: jax_model.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(pc[:1])))
    port = VoteNet(mean_size_arr=cfg.mean_size_arr, **kw)
    port.load_state_dict(state_dict_from_jax(variables))  # strict
    port.eval()
    return dict(cfg=cfg, kw=kw, msa=msa, pc=pc, jax_model=jax_model,
                variables=variables, port=port)


def _compare(jax_out, port_out, keys, atol):
    for key in keys:
        want = np.asarray(jax_out[key])
        got = port_out[key].detach().numpy()
        assert got.shape == want.shape, key
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=key)


def test_set_abstraction_matches_f32(setup):
    jax_out = jax.device_get(jax.jit(
        lambda v, x: setup["jax_model"].apply(v, x, train=False))(
            setup["variables"], jnp.asarray(setup["pc"])))
    with torch.no_grad():
        port_out = setup["port"](torch.from_numpy(setup["pc"]))
    assert set(port_out) == set(jax_out)
    keys = [f"sa{i}_{k}" for i in range(1, 5)
            for k in ("xyz", "features")] + ["sa1_inds", "sa2_inds",
                                             "fp2_inds", "fp2_xyz"]
    _compare(jax_out, port_out, keys, atol=1e-4)


def test_end_points_match_f64(setup):
    jax.config.update("jax_enable_x64", True)
    try:
        jax_model = JaxVoteNet(mean_size_arr=setup["msa"],
                               dtype=jnp.float64, head_dtype=jnp.float64,
                               **setup["kw"])
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     setup["variables"])
        jax_out = jax.device_get(jax.jit(
            lambda v, x: jax_model.apply(v, x, train=False))(
                v64, jnp.asarray(setup["pc"], jnp.float64)))
    finally:
        jax.config.update("jax_enable_x64", False)
    port = VoteNet(mean_size_arr=setup["cfg"].mean_size_arr, **setup["kw"])
    port.load_state_dict(setup["port"].state_dict())
    port.double().eval()
    with torch.no_grad():
        port_out = port(torch.from_numpy(setup["pc"]).double())
    assert set(port_out) == set(jax_out)
    _compare(jax_out, port_out, sorted(jax_out), atol=1e-9)


def test_bridge_maps_every_leaf(setup):
    sd = state_dict_from_jax(setup["variables"])
    assert set(sd) == set(setup["port"].state_dict())
    kernel = setup["variables"]["params"]["pnet"]["out"]["kernel"]
    np.testing.assert_array_equal(sd["pnet.out.weight"].numpy(),
                                  np.asarray(kernel).T)
    mean = setup["variables"]["batch_stats"]["vgen"]["bn1"]["mean"]
    np.testing.assert_array_equal(sd["vgen.bn1.running_mean"].numpy(),
                                  np.asarray(mean))


def test_batchnorm_train_mode_matches_jax():
    """One train-mode batch: output to atol 1e-5 (f32 moments over 640
    rows), updated running statistics to atol 1e-6."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 160, 8)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    jbn = JaxBatchNorm(8)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(8, np.float32),
                                 "var": np.ones(8, np.float32)}}
    want, mut = jbn.apply(variables, jnp.asarray(x), train=True,
                          momentum=0.1, mutable=["batch_stats"])
    bn = BatchNorm(8, momentum=0.1)
    bn.load_state_dict(state_dict_from_jax(variables))
    bn.train()
    got = bn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
