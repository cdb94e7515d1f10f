"""The port's exact first-k ball query (``--query_mode exact``) against the
JAX package's, on the CPU.

* `ops.ball_query` equals the JAX ``ops.ball_query`` bit for bit on
  boundary-free radii (`_boundary_free_radius`): M no multiple of the
  chunk, a centre with no hit and one with fewer hits than slots,
  duplicated points; float32 (the expanded form) and float64 (the direct
  form), and against the numpy oracle of the reference's CUDA loop.
* `SAModuleVotes` and `SAModuleCenters` (normalized and not) in exact
  mode against the JAX modules in float64, weights bridged strictly:
  outputs to atol 1e-9 (indices exactly), and the gradient of the
  features through the gather to atol 1e-12.
* Eval-mode end_points in float64, exact mode, from the reference's own
  initial checkpoints in the repo (``evidence/round5/{wsb,br,gf}/
  ref_init_checkpoint.tar.gz``): VoteNet from WSB's, VoteNet-DA from
  BR's, GroupFree3D (2 decoder layers) from GF's, each imported by the
  port's `tools.torch_import` and by the JAX importer (then run by the JAX
  model). Tolerances of tests/test_torch_votenet.py and
  tests/test_torch_groupfree.py: indices exactly, floats to atol 1e-9,
  GroupFree3D's box heads (float32 in the JAX package) to rtol and atol
  1e-6.
"""

import gzip

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu import ops as jops
from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.models.groupfree import \
    GroupFreeDetector as JaxGroupFree
from backtoreality_tpu.models.votenet import VoteNet as JaxVoteNet
from backtoreality_tpu.models.votenet.da import VoteNetDA as JaxVoteNetDA
from backtoreality_tpu.nn import SAModuleCenters as JaxSAModuleCenters
from backtoreality_tpu.nn import SAModuleVotes as JaxSAModuleVotes
from backtoreality_tpu.tools import torch_import as jimport
from backtoreality_tpu_torch import ops as tops
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.models.groupfree import GroupFreeDetector
from backtoreality_tpu_torch.models.votenet import VoteNet, VoteNetDA
from backtoreality_tpu_torch.nn import SAModuleCenters, SAModuleVotes
from backtoreality_tpu_torch.tools import torch_import as timport
from oracles import ball_query_oracle
from test_ops import make_cloud
from test_torch_ops import _boundary_free_radius

EVIDENCE = "evidence/round5/{}/ref_init_checkpoint.tar.gz"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _query_case(kind, seed=0):
    """(xyz, centres, radius, nsample) for one edge case, float32."""
    rng = np.random.default_rng(seed)
    n, m, s = 700, 300, 16  # 300 centres: a full chunk and a padded one
    xyz = make_cloud(rng, 2, n, pad_frac=0.0, scale=1.5)
    if kind == "duplicates":
        xyz[:, n // 2:] = xyz[:, :n - n // 2]  # every point twice
    centres = xyz[:, rng.permutation(n)[:m]] + rng.normal(
        size=(2, m, 3)).astype(np.float32) * 0.05
    # a centre with no point in reach, and one with three (< 16 slots)
    centres[0, 0] = [40.0, 40.0, 40.0]
    xyz[1, -3:] = [[20.0, 20.0, 20.0], [20.1, 20.0, 20.0],
                   [20.0, 20.1, 20.0]]
    centres[1, 5] = [20.0, 20.0, 20.05]
    r = _boundary_free_radius(xyz, centres, 0.3)
    return xyz, centres.astype(np.float32), r, s


def _check_edges(idx, n):
    assert (idx[0, 0] == 0).all()  # no hit: index 0 in every slot
    row = idx[1, 5]
    assert row[:3].tolist() == [n - 3, n - 2, n - 1]
    assert (row[3:] == n - 3).all()  # slots past the count: the first hit


@pytest.mark.parametrize("kind", ["random", "duplicates"])
def test_ball_query_equals_jax_f32(kind):
    xyz, centres, r, s = _query_case(kind)
    want = np.asarray(jops.ball_query(jnp.asarray(xyz), jnp.asarray(centres),
                                      r, s))
    got = tops.ball_query(torch.from_numpy(xyz), torch.from_numpy(centres),
                          r, s)
    assert got.dtype == torch.int32 and got.shape == (2, 300, s)
    np.testing.assert_array_equal(got.numpy(), want)
    _check_edges(got.numpy(), xyz.shape[1])
    np.testing.assert_array_equal(got.numpy(),
                                  ball_query_oracle(xyz, centres, r, s))


@pytest.mark.parametrize("kind", ["random", "duplicates"])
def test_ball_query_equals_jax_f64(kind, x64):
    """float64 through the direct form |c - p|^2, on both sides."""
    xyz, centres, r, s = _query_case(kind, seed=1)
    xyz, centres = xyz.astype(np.float64), centres.astype(np.float64)
    want = np.asarray(jops.ball_query(jnp.asarray(xyz), jnp.asarray(centres),
                                      r, s))
    got = tops.ball_query(torch.from_numpy(xyz), torch.from_numpy(centres),
                          r, s)
    np.testing.assert_array_equal(got.numpy(), want)
    _check_edges(got.numpy(), xyz.shape[1])


def test_ball_query_chunk_is_only_a_block_size():
    xyz, centres, r, s = _query_case("random", seed=2)
    x, c = torch.from_numpy(xyz), torch.from_numpy(centres)
    whole = tops.ball_query(x, c, r, s)
    for chunk in (1, 7, 256, 1000):
        assert torch.equal(tops.ball_query(x, c, r, s, chunk=chunk), whole)


def _sa_inputs(seed):
    rng = np.random.default_rng(seed)
    xyz = make_cloud(rng, 2, 600, pad_frac=0.0, scale=1.5)
    feats = rng.normal(size=(2, 600, 8))
    centres = xyz[:, :40] + rng.normal(size=(2, 40, 3)).astype(
        np.float32) * 0.05
    centres[0, 0] = [9.0, 9.0, 9.0]  # no neighbour
    return xyz.astype(np.float64), feats, centres.astype(np.float64)


def _v64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _feature_grads(jmod, variables, port, args, gout):
    """d(sum(out * gout))/d(features) in both packages; args ordered as
    the modules take them, the features second."""
    def loss(f):
        a = list(map(jnp.asarray, args))
        a[1] = f
        out = jmod.apply(variables, *a, train=False)
        out = out[1] if isinstance(out, tuple) else out
        return jnp.sum(out * jnp.asarray(gout))

    want = np.asarray(jax.grad(loss)(jnp.asarray(args[1])))
    leaves = [torch.from_numpy(a) for a in args]
    leaves[1].requires_grad_()
    out = port(*leaves)
    out = out[1] if isinstance(out, tuple) else out
    (got,) = torch.autograd.grad(out, leaves[1], torch.from_numpy(gout))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_sa_module_votes_exact_matches_jax_f64(x64):
    xyz, feats, _ = _sa_inputs(3)
    r = _boundary_free_radius(xyz, xyz, 0.4)  # the centres are points
    jmod = JaxSAModuleVotes(npoint=64, radius=r, nsample=16, mlp=[8, 16],
                            normalize_xyz=True, query_mode="exact",
                            dtype=jnp.float64)
    variables = _v64(jax.device_get(jmod.init(
        jax.random.PRNGKey(3), jnp.asarray(xyz), jnp.asarray(feats),
        train=False)))
    want = jmod.apply(variables, jnp.asarray(xyz), jnp.asarray(feats),
                      train=False)
    port = SAModuleVotes(64, r, 16, 8, [8, 16], query_mode="exact")
    port.load_state_dict(state_dict_from_jax(variables))  # strict
    port.double().eval()
    with torch.no_grad():
        got = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)
    gout = np.random.default_rng(4).normal(size=(2, 64, 16))
    _feature_grads(jmod, variables, port, (xyz, feats), gout)


@pytest.mark.parametrize("normalize", [True, False])
def test_sa_module_centers_exact_matches_jax_f64(normalize, x64):
    xyz, feats, centres = _sa_inputs(5)
    r = _boundary_free_radius(xyz, centres, 0.3)
    jmod = JaxSAModuleCenters(radius=r, nsample=8, mlp=[16],
                              normalize_xyz=normalize, query_mode="exact",
                              dtype=jnp.float64)
    args = (xyz, feats, centres)
    variables = _v64(jax.device_get(jmod.init(
        jax.random.PRNGKey(5), *map(jnp.asarray, args), train=False)))
    want = jmod.apply(variables, *map(jnp.asarray, args), train=False)
    port = SAModuleCenters(r, 8, 8, [16], query_mode="exact",
                           normalize_xyz=normalize)
    port.load_state_dict(state_dict_from_jax(variables))  # strict
    port.double().eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)
    gout = np.random.default_rng(6).normal(size=(2, 40, 16))
    _feature_grads(jmod, variables, port, args, gout)


# ---------------------------------------------------------------------------
# end_points from the reference's initial checkpoints
# ---------------------------------------------------------------------------


def _reference_state(name, tmp_path):
    """The evidence init `name`, gunzipped and loaded as the reference
    wrote it."""
    path = tmp_path / f"{name}.tar"
    with gzip.open(EVIDENCE.format(name), "rb") as f:
        path.write_bytes(f.read())
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def cloud():
    """Two clouds of 2048 points with a height feature, float64."""
    rng = np.random.default_rng(7)
    xyz = (rng.random((2, 2048, 3)) * 2 - 1) * [3.0, 3.0, 1.0] + [0, 0, 1.0]
    return np.concatenate([xyz, rng.random((2, 2048, 1))], -1)


def _compare(want, got, loose=()):
    assert set(got) == set(want)
    for key in sorted(want):
        w, g = np.asarray(want[key]), got[key].detach().numpy()
        assert g.shape == w.shape, key
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif key.startswith(loose) and not key.endswith("base_xyz"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("name,model", [("wsb", "votenet"),
                                        ("br", "votenet_da"),
                                        ("gf", "groupfree")])
def test_end_points_from_reference_init_match_jax_f64(name, model, cloud,
                                                      tmp_path):
    cfg = jax_config()
    payload = _reference_state(name, tmp_path)
    sd, _ = jimport.extract_state_dict(payload)
    if model == "groupfree":
        params, stats = jimport.groupfree_state_dict(sd)
        kw = dict(num_proposal=32, num_decoder_layers=2, dim_feedforward=128,
                  input_feature_dim=1, self_position_embedding="loc_learned",
                  cross_position_embedding="xyz_learned")
        jcls, tcls, loose = JaxGroupFree, GroupFreeDetector, (
            "proposal_", "0head_", "last_")
    else:
        params, stats = getattr(jimport, f"{model}_state_dict")(sd)
        kw = dict(num_proposal=32, input_feature_dim=1)
        jcls, tcls = ((JaxVoteNet, VoteNet) if model == "votenet"
                      else (JaxVoteNetDA, VoteNetDA))
        loose = ()
    kw.update(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
              num_size_cluster=cfg.num_size_cluster)
    jax.config.update("jax_enable_x64", True)
    try:
        jmodel = jcls(mean_size_arr=tuple(map(tuple,
                                               cfg.mean_size_arr.tolist())),
                      dtype=jnp.float64, head_dtype=jnp.float64,
                      query_mode="exact", **kw)
        want = jax.device_get(jax.jit(
            lambda v, x: jmodel.apply(v, x, train=False))(
                _v64({"params": params, "batch_stats": stats}),
                jnp.asarray(cloud)))
    finally:
        jax.config.update("jax_enable_x64", False)
    state, _, _ = timport.convert(payload, model)
    port = tcls(mean_size_arr=cfg.mean_size_arr, query_mode="exact", **kw)
    port.load_state_dict(state)  # strict
    port.double().eval()
    with torch.no_grad():
        got = port(torch.from_numpy(cloud))
    _compare(want, got, loose)
