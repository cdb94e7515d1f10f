"""The rest of the VoteNet model and op surface against the JAX package, on
the CPU: `sample_uniformly`, the interpolation helpers, the SA/FP variants
(pooling, `use_xyz`, `group_all`, `SAModuleMSG`, `SAModuleVotesRlt`,
`LFPModuleMSG`), random proposal sampling, `BoxNet`,
`Pointnet2BackboneCam`, `VoteNetDAJitter2` and the six experimental
criteria.

The JAX modules run on the CPU as the JAX package's own tests run them:
their ball query and grouping take the XLA path, the Pallas kernels' plain
reference. Weights are carried by ``bridge.state_dict_from_jax`` with
``strict=True``. Tolerances, stated per test:

* float32 modules in eval mode (a short graph: one grouping and an MLP of
  one to three layers): within 1e-5 of the largest magnitude of the
  compared tensor, indices exactly;
* whole models (BoxNet, VoteNetDAJitter2) in float64 on both sides (JAX
  with x64 on), where float32 is ill-conditioned (the FP layers'
  inverse-distance weights at coincident points): floats to atol 1e-9,
  indices exactly;
* LFP's shared post-MLP in train mode, float64: outputs and every running
  statistic to atol 1e-9;
* criteria in float64: the loss and every aux scalar to rtol 1e-9.

The JAX package's PRNG cannot be replayed in torch: random proposal
sampling and `sample_uniformly` take the JAX side's draws, injected.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu import nn as jnn
from backtoreality_tpu import ops as jops
from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.data.dataset import DetectionDataset
from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.losses import votenet as jlosses
from backtoreality_tpu.models.votenet import BoxNet as JaxBoxNet
from backtoreality_tpu.models.votenet import \
    Pointnet2BackboneCam as JaxBackboneCam
from backtoreality_tpu.models.votenet import ProposalModule as JaxProposal
from backtoreality_tpu.models.votenet import \
    VoteNetDAJitter2 as JaxDAJitter2
from backtoreality_tpu.ops.interpolate import \
    interpolation_weights as jax_interpolation_weights
from backtoreality_tpu.ops.interpolate import \
    three_nn_interpolate as jax_three_nn_interpolate
from backtoreality_tpu_torch import nn as tnn
from backtoreality_tpu_torch import ops as tops
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.losses import votenet as tlosses
from backtoreality_tpu_torch.models.votenet import (BoxNet,
                                                    Pointnet2BackboneCam,
                                                    ProposalModule,
                                                    VoteNetDAJitter2)
from backtoreality_tpu_torch.ops.grouping import _resample_uniformly
from backtoreality_tpu_torch.ops.interpolate import (interpolation_weights,
                                                     three_nn_interpolate)

from test_losses_votenet import make_end_points

B, N, NUM_PROPOSAL = 2, 2048, 64
F32_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _x64(fn, *args):
    """`fn(*args)` with JAX's x64 on, fetched to numpy; numpy leaves of
    the arguments become JAX arrays there (keeping float64)."""
    jax.config.update("jax_enable_x64", True)
    try:
        args = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a,
            args)
        return jax.device_get(fn(*args))
    finally:
        jax.config.update("jax_enable_x64", False)


def _v64(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  variables)


def _load(port, variables):
    """Strict load of a JAX variables tree; the names must cover the
    port's state exactly, leaving no entry fresh."""
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)  # strict
    return port


def _close_rel(got, want, rel=F32_REL, what=""):
    """max |got - want| within `rel` of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= rel * scale, f"{what}: {err:.3e} of max {scale:.3e}"


def _compare(want, got, atol, keys=None):
    keys = sorted(want) if keys is None else keys
    for key in keys:
        w = np.asarray(want[key])
        g = got[key].detach().numpy()
        assert g.shape == w.shape, key
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_sample_uniformly_matches_jax():
    """The exact query's slot-filled indices resampled with the JAX
    function's own uniform draws injected: bitwise equal indices and
    counts. The port's generator path reads only its generator."""
    rng = np.random.default_rng(0)
    xyz = rng.random((2, 300, 3)).astype(np.float32)
    ctr = xyz[:, :40].copy()
    idx = np.array(jops.ball_query(jnp.asarray(xyz), jnp.asarray(ctr),
                                   0.15, 16))
    assert (idx == idx[..., :1]).any()  # some slots are fills
    key = jax.random.PRNGKey(3)
    want_idx, want_cnt = jops.sample_uniformly(jnp.asarray(idx), key)
    u = jax.random.uniform(key, idx.shape)  # the JAX function's draw
    got_idx, got_cnt = _resample_uniformly(torch.from_numpy(idx),
                                           torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    assert got_idx.dtype == got_cnt.dtype == torch.int32

    state = torch.get_rng_state()
    t_idx = torch.from_numpy(idx)
    one = tops.sample_uniformly(t_idx, torch.Generator().manual_seed(1))
    two = tops.sample_uniformly(t_idx, torch.Generator().manual_seed(1))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(one[0], two[0])
    # each fill slot takes one of its region's found neighbours
    found = [set(r[:c]) for r, c in zip(idx.reshape(-1, 16),
                                        one[1].numpy().reshape(-1))]
    assert all(set(r) <= f for r, f in zip(one[0].numpy().reshape(-1, 16),
                                           found))
    with pytest.raises(TypeError):
        tops.sample_uniformly(t_idx, None)


def test_interpolation_helpers_match_jax():
    """`interpolation_weights` in float32, within 1e-5 of the largest
    weight; `three_nn_interpolate` in float64 on both sides (float32
    distances of near neighbours are ill-conditioned, as in the FP
    layers), to atol 1e-9."""
    rng = np.random.default_rng(1)
    dist = rng.random((2, 50, 3)).astype(np.float32)
    _close_rel(interpolation_weights(torch.from_numpy(dist)).numpy(),
               jax_interpolation_weights(jnp.asarray(dist)), what="weights")
    known = rng.random((2, 64, 3)) * 2
    unknown = rng.random((2, 200, 3)) * 2
    feats = rng.normal(size=(2, 64, 8))
    want = _x64(jax_three_nn_interpolate, feats, known, unknown)
    got = three_nn_interpolate(*map(torch.from_numpy,
                                    (feats, known, unknown)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# SA / FP variants (float32, eval mode)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(7)
    xyz = ((rng.random((2, 600, 3)) * 2 - 1) * 1.5).astype(np.float32)
    feats = rng.normal(size=(2, 600, 5)).astype(np.float32)
    return xyz, feats


def _jax_apply(mod, *args):
    """A module's init and its eval-mode output, each one compiled
    program."""
    variables = jax.device_get(jax.jit(
        lambda k, *a: mod.init(k, *a, train=False))(
            jax.random.PRNGKey(1), *args))
    return variables, jax.jit(
        lambda v, *a: mod.apply(v, *a, train=False))(variables, *args)


def test_group_all_matches_jax(cloud):
    xyz, feats = map(torch.from_numpy, cloud)
    for f, use_xyz in ((feats, True), (feats, False), (None, True)):
        want = jnn.group_all(jnp.asarray(xyz.numpy()),
                             None if f is None else jnp.asarray(f.numpy()),
                             use_xyz)
        got = tnn.group_all(xyz, f, use_xyz)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tnn.SAModuleOffset is tnn.SAModuleCenters


SA_OPTIONS = {
    "avg": dict(pooling="avg"),
    "rbf": dict(pooling="rbf"),
    "rbf_sigma": dict(pooling="rbf", sigma=0.45),
    "no_xyz": dict(use_xyz=False),
    "rbf_unnormalized": dict(pooling="rbf", normalize_xyz=False),
}


@pytest.mark.parametrize("option", sorted(SA_OPTIONS))
def test_sa_votes_options_match_jax(cloud, option):
    """`SAModuleVotes` with the options the recipes never set: pooled
    features within 1e-5 of the largest, indices and centres exactly."""
    kw = {"normalize_xyz": True, **SA_OPTIONS[option]}
    xyz, feats = cloud
    jmod = jnn.SAModuleVotes(npoint=48, radius=0.6, nsample=8,
                             mlp=(16, 32), **kw)
    variables, want = _jax_apply(jmod, jnp.asarray(xyz), jnp.asarray(feats))
    port = _load(tnn.SAModuleVotes(48, 0.6, 8, in_features=5, mlp=[16, 32],
                                   **kw), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close_rel(got[1].numpy(), want[1], what=option)


@pytest.mark.parametrize("pooling", ["avg", "rbf"])
def test_sa_centers_pooling_matches_jax(cloud, pooling):
    """`SAModuleCenters` (= `SAModuleOffset`) with avg and rbf pooling,
    radius-normalized: within 1e-5 of the largest."""
    xyz, feats = cloud
    centres = xyz[:, 100:120].copy()
    jmod = jnn.SAModuleOffset(radius=0.5, nsample=8, mlp=[16],
                              normalize_xyz=True, pooling=pooling)
    variables, want = _jax_apply(jmod, *map(jnp.asarray,
                                            (xyz, feats, centres)))
    port = _load(tnn.SAModuleOffset(0.5, 8, in_features=5, mlp=[16],
                                    normalize_xyz=True, pooling=pooling),
                 variables).eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (xyz, feats, centres)))
    _close_rel(got.numpy(), want, what=pooling)


MSG_CASES = {
    "normalized": dict(npoint=48, normalize_xyz=True, feats=True),
    "unnormalized": dict(npoint=48, normalize_xyz=False, feats=True),
    "no_features": dict(npoint=48, normalize_xyz=False, feats=False),
    "group_all": dict(npoint=None, normalize_xyz=False, feats=True),
}


@pytest.mark.parametrize("case", sorted(MSG_CASES))
def test_sa_msg_matches_jax(cloud, case):
    """`SAModuleMSG`, two branches (0.3/8/[16,16], 0.6/16/[16,32]): the
    concatenated features within 1e-5 of the largest, indices and centres
    exactly; npoint None groups the whole cloud."""
    spec = MSG_CASES[case]
    xyz, feats = cloud
    feats = feats if spec["feats"] else None
    kw = dict(radii=[0.3, 0.6], nsamples=[8, 16], mlps=[[16, 16], [16, 32]],
              normalize_xyz=spec["normalize_xyz"])
    jmod = jnn.SAModuleMSG(npoint=spec["npoint"], **kw)
    args = (jnp.asarray(xyz), None if feats is None else jnp.asarray(feats))
    variables, want = _jax_apply(jmod, *args)
    port = _load(tnn.SAModuleMSG(spec["npoint"], in_features=0 if feats is
                                 None else 5, **kw), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(xyz),
                   None if feats is None else torch.from_numpy(feats))
    if spec["npoint"] is None:
        assert got[0] is None and want[0] is None
        assert got[1].shape == (2, 1, 16 + 32)
    else:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close_rel(got[1].numpy(), want[1], what=case)


@pytest.mark.parametrize("use_xyz", [True, False])
def test_sa_votes_rlt_matches_jax(cloud, use_xyz):
    """`SAModuleVotesRlt`: the MLP's input width 3 + 2C (2C without xyz),
    the pooled features within 1e-5 of the largest; the centre features
    come from the ungrouped features at the FPS indices."""
    xyz, feats = cloud
    jmod = jnn.SAModuleVotesRlt(npoint=32, radius=0.5, nsample=8,
                                mlp=[16, 16], use_xyz=use_xyz)
    variables, want = _jax_apply(jmod, jnp.asarray(xyz), jnp.asarray(feats))
    port = _load(tnn.SAModuleVotesRlt(32, 0.5, 8, in_features=5,
                                      mlp=[16, 16], use_xyz=use_xyz),
                 variables).eval()
    assert port.mlp.dense0.in_features == (3 if use_xyz else 0) + 2 * 5
    with torch.no_grad():
        got = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close_rel(got[1].numpy(), want[1], what="rlt")


def _lfp_inputs():
    rng = np.random.default_rng(5)
    xyz1 = ((rng.random((2, 256, 3)) * 2 - 1) * 1.5).astype(np.float32)
    xyz2 = ((rng.random((2, 96, 3)) * 2 - 1) * 1.5).astype(np.float32)
    f1 = rng.normal(size=(2, 256, 6)).astype(np.float32)
    f2 = rng.normal(size=(2, 96, 4)).astype(np.float32)
    return xyz2, xyz1, f2, f1


LFP_KW = dict(radii=[0.4, 0.8], nsamples=[8, 16], mlps=[[16, 16], [8, 16]],
              post_mlp=[24, 12])


@pytest.mark.parametrize("skip", [True, False])
def test_lfp_msg_matches_jax_eval(skip):
    """`LFPModuleMSG` in eval mode, with and without the skip features:
    within 1e-5 of the largest."""
    xyz2, xyz1, f2, f1 = _lfp_inputs()
    f2 = f2 if skip else None
    jmod = jnn.LFPModuleMSG(**LFP_KW)
    variables, want = _jax_apply(
        jmod, jnp.asarray(xyz2), jnp.asarray(xyz1),
        None if f2 is None else jnp.asarray(f2), jnp.asarray(f1))
    port = _load(tnn.LFPModuleMSG(in_features1=6, in_features2=4 if skip
                                  else 0, **LFP_KW), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(xyz2), torch.from_numpy(xyz1),
                   None if f2 is None else torch.from_numpy(f2),
                   torch.from_numpy(f1))
    assert got.shape == (2, 96, 2 * 12)
    _close_rel(got.numpy(), want, what="lfp")


def test_lfp_shared_post_mlp_train_mode_matches_jax_f64():
    """Train mode, float64: the post-MLP is one module called once per
    scale, so its BN running statistics move twice, the second move from
    the first, as Flax's shared module's; outputs and every running
    statistic to atol 1e-9."""
    xyz2, xyz1, f2, f1 = _lfp_inputs()
    variables, _ = _jax_apply(jnn.LFPModuleMSG(**LFP_KW),
                              *map(jnp.asarray, (xyz2, xyz1, f2, f1)))
    v64 = _v64(variables)
    jmod = jnn.LFPModuleMSG(dtype=jnp.float64, **LFP_KW)
    want, mut = _x64(jax.jit(lambda v, *a: jmod.apply(
        v, *a, train=True, bn_momentum=0.1, mutable=["batch_stats"])),
        v64, *(a.astype(np.float64) for a in (xyz2, xyz1, f2, f1)))
    port = _load(tnn.LFPModuleMSG(in_features1=6, in_features2=4,
                                  **LFP_KW), v64).double().train()
    got = port(*(torch.from_numpy(a.astype(np.float64))
                 for a in (xyz2, xyz1, f2, f1)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-9)
    stats = state_dict_from_jax({"batch_stats": mut["batch_stats"]})
    buffers = dict(port.named_buffers())
    assert set(stats) == set(buffers)
    for name, value in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   rtol=0, atol=1e-9, err_msg=name)
    # twice: one move from the initial statistics would differ
    post = v64["batch_stats"]["post_mlp"]["bn0"]["mean"]
    assert not np.allclose(buffers["post_mlp.bn0.running_mean"].numpy(),
                           0.9 * post + 0.1 * stats[
                               "post_mlp.bn0.running_mean"].numpy())


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A labelled batch (B=2, N=2048, height, float64 floats) and the
    model kwargs."""
    cfg = jax_config()
    root = tmp_path_factory.mktemp("torch_surface")
    write_synthetic_scans(root, cfg, num_scans=B, num_objects=4,
                          points_per_object=400, floor_points=800, seed=4)
    ds = DetectionDataset(cfg, root, split="all", num_points=N,
                          use_height=True, center_jitter=0.1)
    items = [ds.get(i) for i in range(B)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in batch.items()}
    kw = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
              num_size_cluster=cfg.num_size_cluster, input_feature_dim=1,
              num_proposal=NUM_PROPOSAL)
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    return dict(cfg=cfg, batch=batch, kw=kw, msa=msa)


def _jax_init(model, *args):
    sample = [jnp.asarray(a[:1], jnp.float32) if a.dtype == np.float64
              else jnp.asarray(a[:1]) for a in args]
    return jax.device_get(jax.jit(
        lambda k, *a: model.init(k, *a, train=False))(
            jax.random.PRNGKey(0), *sample))


def _jax_forward_f64(cls, kw, variables, *args):
    def run(v, *a):
        model = cls(dtype=jnp.float64, **kw)
        return jax.jit(lambda v, *a: model.apply(v, *a, train=False))(v, *a)
    return _x64(run, _v64(variables), *args)


@pytest.fixture(scope="module")
def boxnet(setup):
    kw = dict(setup["kw"], mean_size_arr=setup["msa"])
    pc = setup["batch"]["point_clouds"]
    variables = _jax_init(JaxBoxNet(**kw), pc)
    want = _jax_forward_f64(JaxBoxNet, kw, variables, pc)
    port = BoxNet(mean_size_arr=setup["cfg"].mean_size_arr, **setup["kw"])
    _load(port, _v64(variables)).double().eval()
    with torch.no_grad():
        got = port(torch.from_numpy(pc))
    return variables, want, got


def test_boxnet_end_points_match_jax_f64(boxnet):
    """BoxNet end to end in float64 (the proposals straight from the
    seeds: no vote entries): every end_points entry, floats to atol 1e-9,
    indices exactly."""
    _, want, got = boxnet
    assert set(got) == set(want)
    assert not any(k.startswith("vote_") for k in got)
    _compare(want, got, atol=1e-9)


def test_get_loss_boxnet_matches_jax_f64(setup, boxnet):
    """`get_loss_boxnet` on BoxNet's float64 end_points merged with the
    labels: the loss and every aux scalar to rtol 1e-9, the objectness
    labels and assignment exactly; no vote loss."""
    _, want, _ = boxnet
    ep = {**setup["batch"], **{k: np.asarray(v) for k, v in want.items()}}
    _, aux_j = _x64(lambda e: jlosses.get_loss_boxnet(e, setup["cfg"]), ep)
    loss, aux = tlosses.get_loss_boxnet(
        {k: torch.from_numpy(np.array(v)) for k, v in ep.items()},
        setup["cfg"])
    assert "vote_loss" not in aux and set(aux) == set(aux_j)
    for key, value in aux_j.items():
        if np.ndim(value) == 0:
            np.testing.assert_allclose(aux[key].item(), float(value),
                                       rtol=1e-9, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(aux[key].numpy(),
                                          np.asarray(value), err_msg=key)
    assert torch.isfinite(loss)


@pytest.fixture(scope="module")
def cam(setup):
    pc = setup["batch"]["point_clouds"].astype(np.float32)
    return _jax_apply(JaxBackboneCam(input_feature_dim=1), jnp.asarray(pc))


def test_backbone_cam_matches_jax(setup, cam):
    """`Pointnet2BackboneCam` in float32: SA1-SA4 and no FP layers; the
    indices exactly, coordinates and features within 1e-5 of the largest
    (a short graph a layer; the layers' inputs agree)."""
    variables, want = cam
    pc = setup["batch"]["point_clouds"].astype(np.float32)
    port = _load(Pointnet2BackboneCam(input_feature_dim=1), variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(pc))
    assert set(got) == set(want)
    assert "fp2_features" not in got
    for key in sorted(want):
        if key.endswith("_inds"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        else:
            _close_rel(got[key].numpy(), want[key], what=key)


JITTER2_KEYS = ("point_clouds", "center_label", "sem_cls_label")


@pytest.fixture(scope="module")
def jitter2(setup):
    kw = dict(setup["kw"], mean_size_arr=setup["msa"])
    args = [setup["batch"][k] for k in JITTER2_KEYS]
    variables = _jax_init(JaxDAJitter2(**kw), *args)
    return variables, kw, args


def _jitter2_port(setup, variables):
    port = VoteNetDAJitter2(mean_size_arr=setup["cfg"].mean_size_arr,
                            **setup["kw"])
    return _load(port, _v64(variables)).double()


def test_da_jitter2_end_points_match_jax_f64(setup, jitter2):
    """`VoteNetDAJitter2` end to end in float64, eval mode: every
    end_points entry (the DA predictions, `center_features` grouped from
    the aggregated votes, `jitter_pred`), floats to atol 1e-9, indices
    exactly."""
    variables, kw, args = jitter2

    def run(v, *a):
        model = JaxDAJitter2(dtype=jnp.float64, head_dtype=jnp.float64,
                             **kw)
        return jax.jit(lambda v, *a: model.apply(v, *a, train=False))(v, *a)

    want = _x64(run, _v64(variables), *args)
    port = _jitter2_port(setup, variables).eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    assert set(got) == set(want)
    for key in ("center_features", "jitter_pred", "global_d_pred",
                "local_d_pred"):
        assert key in got
    assert got["center_features"].shape == (B, 64, 128 + setup[
        "cfg"].num_class)
    _compare(want, got, atol=1e-9)


def test_da_jitter2_head_gradient_matches_jax_f64(setup, jitter2):
    """The jitter head groups the aggregated votes with their features
    detached and their positions not: the gradient of the jitter
    prediction's sum reaches the voting module through the positions
    alone. Against `jax.grad` of the same sum (train=False), every
    parameter's gradient within 1e-9 of its norm (atol 1e-12), on the
    first scene."""
    variables, kw, args = jitter2
    v64 = _v64(variables)
    args = [a[:1] for a in args]  # one scene

    def grads(v, *a):
        model = JaxDAJitter2(dtype=jnp.float64, head_dtype=jnp.float64,
                             **kw)

        def total(params):
            ep = model.apply({"params": params,
                              "batch_stats": v["batch_stats"]}, *a,
                             train=False)
            return jnp.sum(ep["jitter_pred"])
        return jax.jit(jax.grad(total))(v["params"])

    want = state_dict_from_jax({"params": _x64(grads, v64, *args)})
    port = _jitter2_port(setup, variables).eval()
    port(*map(torch.from_numpy, args))["jitter_pred"].sum().backward()
    params = dict(port.named_parameters())
    for name, w in want.items():
        g = params[name].grad
        got = np.zeros(w.shape) if g is None else g.numpy()
        err = np.linalg.norm(got - w.numpy())
        assert err <= 1e-9 * np.linalg.norm(w.numpy()) + 1e-12, name
    # the positions carry it to the votes; the features are detached
    assert np.linalg.norm(want["vgen.out.weight"]) > 0
    assert np.linalg.norm(
        want["pnet.vote_aggregation.mlp.dense0.weight"]) == 0


def test_random_proposal_sampling_matches_jax_f64():
    """`sampling="random"`: the JAX module's draw (``jax.random.randint``
    with its key) injected as `sample_inds`, every output in float64 to
    atol 1e-9; the port's own draw reads only the generator it is given,
    and a call without one raises."""
    cfg = jax_config()
    rng = np.random.default_rng(6)
    b, num_vote = 2, 256
    xyz = ((rng.random((b, num_vote, 3)) * 2 - 1) * 1.5)
    feats = rng.normal(size=(b, num_vote, 256))
    seeds = xyz + rng.normal(0, 0.05, xyz.shape)
    kw = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
              num_size_cluster=cfg.num_size_cluster, num_proposal=32,
              sampling="random")
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    key = jax.random.PRNGKey(9)
    jmod = JaxProposal(mean_size_arr=msa, **kw)
    variables = jax.device_get(jax.jit(
        lambda k, x, f, s: jmod.init(k, x, f, {"seed_xyz": s}, key,
                                     train=False))(
            jax.random.PRNGKey(0), *(jnp.asarray(a, jnp.float32)
                                     for a in (xyz, feats, seeds))))

    def run(v, x, f, s):
        model = JaxProposal(mean_size_arr=msa, dtype=jnp.float64, **kw)
        return jax.jit(lambda v, x, f, s: model.apply(
            v, x, f, {"seed_xyz": s}, key, train=False))(v, x, f, s)

    want = _x64(run, _v64(variables), xyz, feats, seeds)
    draw = np.asarray(jax.random.randint(key, (b, 32), 0, num_vote,
                                         dtype=jnp.int32))
    np.testing.assert_array_equal(want["aggregated_vote_inds"], draw)
    port = _load(ProposalModule(mean_size_arr=cfg.mean_size_arr, **kw),
                 _v64(variables)).double().eval()
    t = {k: torch.from_numpy(v) for k, v in
         dict(xyz=xyz, feats=feats, seeds=seeds).items()}
    with torch.no_grad():
        got = port(t["xyz"], t["feats"], {"seed_xyz": t["seeds"]},
                   sample_inds=torch.from_numpy(draw.copy()))
    _compare(want, got, atol=1e-9,
             keys=sorted(k for k in want if k != "seed_xyz"))

    state = torch.get_rng_state()
    with torch.no_grad():
        one = port(t["xyz"], t["feats"], {"seed_xyz": t["seeds"]},
                   torch.Generator().manual_seed(2))
        two = port(t["xyz"], t["feats"], {"seed_xyz": t["seeds"]},
                   torch.Generator().manual_seed(2))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(one["aggregated_vote_inds"],
                       two["aggregated_vote_inds"])
    assert one["aggregated_vote_inds"].dtype == torch.int32
    with pytest.raises(TypeError):
        port(t["xyz"], t["feats"], {"seed_xyz": t["seeds"]})


@pytest.mark.parametrize("model", ["VoteNet", "BoxNet", "VoteNetDAJitter2"])
def test_models_pass_the_generator_to_random_sampling(model):
    """A model built with ``sampling="random"`` takes the generator as
    the JAX models take their rng: the same generator state gives the same
    proposals, the global RNG is not read, and a call without one
    raises."""
    from backtoreality_tpu_torch.models import votenet as tvotenet

    cfg = jax_config()
    torch.manual_seed(0)
    net = getattr(tvotenet, model)(
        num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
        num_size_cluster=cfg.num_size_cluster,
        mean_size_arr=cfg.mean_size_arr, num_proposal=16,
        sampling="random").eval()
    rng = np.random.default_rng(12)
    args = [torch.from_numpy(rng.random((1, 1024, 3)).astype(np.float32))]
    if model == "VoteNetDAJitter2":
        args += [torch.from_numpy(rng.random((1, 8, 3)).astype(np.float32)),
                 torch.zeros(1, 8, dtype=torch.int32)]
    state = torch.get_rng_state()
    with torch.no_grad():
        one, two = (net(*args, torch.Generator().manual_seed(4))
                    for _ in range(2))
        with pytest.raises(TypeError):
            net(*args)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(one["aggregated_vote_inds"],
                       two["aggregated_vote_inds"])
    assert torch.equal(one["center"], two["center"])


# ---------------------------------------------------------------------------
# Strict loads
# ---------------------------------------------------------------------------


def _module_cases():
    """(JAX module, its init args, the port's module) per new module; the
    trees of the two detectors and of the SA-only backbone come from the
    `boxnet`, `jitter2` and `cam` fixtures."""
    rng = np.random.default_rng(8)
    xyz = rng.random((1, 1024, 3)).astype(np.float32)
    feats = rng.normal(size=(1, 1024, 6)).astype(np.float32)
    return {
        "SAModuleMSG": (
            jnn.SAModuleMSG(npoint=32, radii=[0.2, 0.4], nsamples=[8, 16],
                            mlps=[[16], [8, 16]]), (xyz, feats),
            lambda: tnn.SAModuleMSG(32, [0.2, 0.4], [8, 16], 6,
                                    [[16], [8, 16]])),
        "SAModuleVotesRlt": (
            jnn.SAModuleVotesRlt(npoint=32, radius=0.3, nsample=8,
                                 mlp=[16, 8]), (xyz, feats),
            lambda: tnn.SAModuleVotesRlt(32, 0.3, 8, 6, [16, 8])),
        "LFPModuleMSG": (
            jnn.LFPModuleMSG(radii=[0.3], nsamples=[8], mlps=[[16]],
                             post_mlp=[8, 8]),
            (xyz[:, :64], xyz, feats[:, :64], feats),
            lambda: tnn.LFPModuleMSG([0.3], [8], 6, 6, [[16]], [8, 8])),
    }


@pytest.mark.parametrize("name", ["BoxNet", "Pointnet2BackboneCam",
                                  "VoteNetDAJitter2", "SAModuleMSG",
                                  "SAModuleVotesRlt", "LFPModuleMSG"])
def test_strict_load_from_jax(name, setup, boxnet, jitter2, cam):
    """A JAX variables tree of each new module loads through `bridge`
    with ``strict=True``: the names are exactly the port's state, no entry
    left fresh, and every parameter and statistic equal to the JAX
    leaf."""
    cfg = setup["cfg"]
    if name == "BoxNet":
        variables = boxnet[0]
        port = BoxNet(mean_size_arr=cfg.mean_size_arr, **setup["kw"])
    elif name == "VoteNetDAJitter2":
        variables = jitter2[0]
        port = VoteNetDAJitter2(mean_size_arr=cfg.mean_size_arr,
                                **setup["kw"])
    elif name == "Pointnet2BackboneCam":
        variables = cam[0]
        port = Pointnet2BackboneCam(input_feature_dim=1)
    else:
        jmod, args, make = _module_cases()[name]
        variables, _ = _jax_apply(jmod, *map(jnp.asarray, args))
        port = make()
    sd = state_dict_from_jax(variables)
    _load(port, variables)
    for key, value in port.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), sd[key].numpy(),
                                      err_msg=key)


# ---------------------------------------------------------------------------
# The six criteria, on hand-made end_points (float64)
# ---------------------------------------------------------------------------


def _hand_made():
    """`TestDeadVotenetLosses`'s pair: the JAX tests' end_points with the
    domain predictions, the scene labels, a CAM, the vote-feature
    discriminator and aggregation indices; float64 numpy."""
    rng = np.random.default_rng(3)
    cloud_label = (rng.random((2, jax_config().num_class)) > 0.5).astype(
        np.float32)
    eps = []
    for seed in (1, 2):
        ep = {k: np.asarray(v) for k, v in make_end_points(seed=seed).items()}
        r = np.random.default_rng(10 + seed)
        ep["global_d_pred"] = r.normal(size=(2, 2))
        ep["local_d_pred"] = r.random((2, 8, 1))
        ep["vote_feature_d_pred"] = r.normal(size=(2, 2))
        ep["cloud_label"] = cloud_label
        ep["cam"] = r.normal(size=(2, 8, jax_config().num_class))
        ep["aggregated_vote_inds"] = r.integers(0, 16, (2, 8)).astype(
            np.int32)
        eps.append({k: v.astype(np.float64) if v.dtype == np.float32 else v
                    for k, v in ep.items()})
    return eps


CRITERIA = {
    "compute_sem_cls_loss": lambda m, s, t, c: m.compute_sem_cls_loss(s, c),
    "compute_objectness_loss_boxnet":
        lambda m, s, t, c: m.compute_objectness_loss_boxnet(s),
    "get_loss_boxnet": lambda m, s, t, c: m.get_loss_boxnet(s, c),
    "get_loss_DA_separate":
        lambda m, s, t, c: m.get_loss_DA_separate(s, t, c),
    "get_loss_cam": lambda m, s, t, c: m.get_loss_cam(s, c),
    "get_loss_DA_cam": lambda m, s, t, c: m.get_loss_DA_cam(s, t, c),
}


def _flat(out):
    """A criterion's result as {name: array}: (loss, aux), a tuple of
    tensors, or one scalar."""
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1],
                                                               dict):
        return {"loss": out[0], **out[1]}
    if isinstance(out, tuple):
        return {f"out{i}": v for i, v in enumerate(out)}
    return {"loss": out}


@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_criterion_matches_jax_f64(name):
    """Each criterion in float64 on both sides: floats to rtol 1e-9,
    integer tensors exactly, the same aux keys."""
    cfg = jax_config()
    ep_S, ep_T = _hand_made()
    fn = CRITERIA[name]
    want = _flat(_x64(lambda s, t: fn(jlosses, s, t, cfg), ep_S, ep_T))
    got = _flat(fn(tlosses, *({k: torch.from_numpy(v) for k, v in ep.items()}
                              for ep in (ep_S, ep_T)), cfg))
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].detach().numpy()
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=key)


def test_da_cam_gradient_through_vote_feature_d_pred_f64():
    """`get_loss_DA_cam`'s gradient with respect to both domains'
    `vote_feature_d_pred` (the vote-feature discriminator's input to the
    focal term) against `jax.grad`, float64, atol 1e-12; non-zero."""
    cfg = jax_config()
    ep_S, ep_T = _hand_made()

    def grads(s, t):
        def total(vs, vt):
            return jlosses.get_loss_DA_cam(
                dict(s, vote_feature_d_pred=vs),
                dict(t, vote_feature_d_pred=vt), cfg)[0]
        return jax.grad(total, argnums=(0, 1))(s["vote_feature_d_pred"],
                                               t["vote_feature_d_pred"])

    want = _x64(grads, ep_S, ep_T)
    ts, tt = ({k: torch.from_numpy(v) for k, v in ep.items()}
              for ep in (ep_S, ep_T))
    for ep in (ts, tt):
        ep["vote_feature_d_pred"].requires_grad_(True)
    tlosses.get_loss_DA_cam(ts, tt, cfg)[0].backward()
    for ep, w in zip((ts, tt), want):
        g = ep["vote_feature_d_pred"].grad.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-12)
        assert np.abs(g).sum() > 0

