"""The port's WSB, BR and BR+CenterRefine slice against the JAX package's,
on the CPU.

One labelled pair of batches (B=2, N=2048, height feature, 64 proposals,
centre jitter 0.1): the source from virtual scans (``scene_aug`` under a
path holding ``obj``, split ``train_aug``), the target from real scans.

* Criteria: `get_loss_weak`, `get_loss_DA` and `get_loss_DA_jitter`
  (epochs 0, 30 and 90: before, on and after the ramp's end) on the same
  float64 end_points in both packages; the loss and every aux scalar to
  rtol 1e-9.
* Models: `VoteNetDA` and `VoteNetDAJitter` end_points against the JAX
  models key by key in float64, eval mode, weights bridged strictly;
  indices exactly, floats to atol 1e-9.
* `SAModuleCenters` (the jitter head's layer) against the JAX module in
  float32: pooled features to atol 1e-5; its grouping at radius 1.0 is
  the un-normalized grouping bit for bit.
* One DA step at init against `make_da_train_step` with an optax
  transformation that captures the gradients, float64, BR and
  CenterRefine: the loss and aux scalars to rtol 1e-9, every parameter
  gradient within 1e-7 of its leaf's norm (the domain heads reach the
  backbone through `grad_reverse`), and the BN running statistics after
  the source-then-target forwards to atol 1e-9.
* The BR -> CenterRefine graft copies and keeps as many leaves as the JAX
  package's `partial_restore`.

The entry points are tested in tests/test_torch_recipes.py.
"""

import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.data.dataset import DetectionDataset
from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.losses import votenet as jlosses
from backtoreality_tpu.models.votenet.da import VoteNetDA as JaxVoteNetDA
from backtoreality_tpu.models.votenet.da import \
    VoteNetDAJitter as JaxVoteNetDAJitter
from backtoreality_tpu.train import common as jcommon
from backtoreality_tpu.train.votenet import \
    make_da_train_step as jax_da_train_step
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.losses import votenet as tlosses
from backtoreality_tpu_torch.models.votenet import (VoteNetDA,
                                                    VoteNetDAJitter,
                                                    grad_reverse)
from backtoreality_tpu_torch.nn import set_bn_momentum
from backtoreality_tpu_torch.train import common as tcommon
from backtoreality_tpu_torch.train.votenet import (make_da_train_step,
                                                   to_device)

B, N, NUM_PROPOSAL = 2, 2048, 64
BN_MOMENTUM = 0.1
JAX_MODELS = {"da": JaxVoteNetDA, "da_jitter": JaxVoteNetDAJitter}
PORT_MODELS = {"da": VoteNetDA, "da_jitter": VoteNetDAJitter}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _batch(root, split, cfg):
    ds = DetectionDataset(cfg, root, split=split, num_points=N,
                          use_height=True, center_jitter=0.1)
    items = [ds.get(i) for i in range(B)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def _args(batch, jitter):
    keys = ["point_clouds"] + (["center_label", "sem_cls_label"]
                               if jitter else [])
    return [batch[k] for k in keys]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The source and target batches (float64) and both JAX models'
    float32 inits."""
    cfg = jax_config()
    real = tmp_path_factory.mktemp("torch_da_real")
    virtual = tmp_path_factory.mktemp("torch_da") / "obj_aug"
    write_synthetic_scans(real, cfg, num_scans=B, num_objects=4,
                          points_per_object=400, floor_points=800, seed=2)
    write_synthetic_scans(virtual, cfg, num_scans=B, num_objects=4,
                          points_per_object=400, floor_points=800, seed=3,
                          prefix="scene_aug")
    batch_S = _batch(virtual, "train_aug", cfg)
    batch_T = _batch(real, "all", cfg)
    assert np.abs(batch_S["center_jitter"]).max() > 0  # the virtual draw
    kw = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
              num_size_cluster=cfg.num_size_cluster, input_feature_dim=1,
              num_proposal=NUM_PROPOSAL)
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    variables = {}
    for kind, cls in JAX_MODELS.items():
        model = cls(mean_size_arr=msa, **kw)
        sample = [jnp.asarray(a[:1]).astype(jnp.float32)
                  if a.dtype == np.float64 else jnp.asarray(a[:1])
                  for a in _args(batch_T, kind == "da_jitter")]
        variables[kind] = jax.device_get(jax.jit(
            lambda k, *a: model.init(k, *a, train=False))(
                jax.random.PRNGKey(0), *sample))
    return dict(cfg=cfg, batch_S=batch_S, batch_T=batch_T, kw=kw, msa=msa,
                variables=variables)


def _v64(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  variables)


def _port_model(setup, kind):
    model = PORT_MODELS[kind](mean_size_arr=setup["cfg"].mean_size_arr,
                              **setup["kw"])
    model.load_state_dict(state_dict_from_jax(_v64(
        setup["variables"][kind])))  # strict
    return model.double()


def _jax_model(setup, kind):
    return JAX_MODELS[kind](mean_size_arr=setup["msa"], dtype=jnp.float64,
                            head_dtype=jnp.float64, **setup["kw"])


@pytest.fixture(scope="module")
def jax_end_points(setup):
    """The JAX jitter model's eval-mode end_points on both batches, merged
    with the labels, float64 numpy: the criteria's common input."""
    jax.config.update("jax_enable_x64", True)
    try:
        model = _jax_model(setup, "da_jitter")
        fwd = jax.jit(lambda v, *a: model.apply(v, *a, train=False))
        v64 = _v64(setup["variables"]["da_jitter"])
        out = []
        for batch in (setup["batch_S"], setup["batch_T"]):
            ep = jax.device_get(fwd(v64, *map(jnp.asarray,
                                              _args(batch, True))))
            out.append({**batch, **{k: np.asarray(v)
                                    for k, v in ep.items()}})
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_loss(fn, *args):
    jax.config.update("jax_enable_x64", True)
    try:
        conv = [{k: jnp.asarray(v) for k, v in a.items()}
                if isinstance(a, dict) else a for a in args]
        return jax.device_get(fn(*conv))
    finally:
        jax.config.update("jax_enable_x64", False)


def _torch_eps(*eps):
    return [{k: torch.from_numpy(np.array(v))
             for k, v in ep.items()} for ep in eps]


def _check_aux(aux, aux_j):
    scalars = {k: v for k, v in aux_j.items() if np.ndim(v) == 0}
    assert set(scalars) <= set(aux)
    for key, want in scalars.items():
        np.testing.assert_allclose(aux[key].item(), float(want), rtol=1e-9,
                                   atol=0, err_msg=key)


def test_get_loss_weak_matches_jax(setup, jax_end_points):
    cfg = setup["cfg"]
    ep_T = jax_end_points[1]
    _, aux_j = _jax_loss(lambda e: jlosses.get_loss_weak(e, cfg), ep_T)
    _, aux = tlosses.get_loss_weak(_torch_eps(ep_T)[0], cfg)
    _check_aux(aux, aux_j)


def test_get_loss_da_matches_jax(setup, jax_end_points):
    cfg = setup["cfg"]
    _, aux_j = _jax_loss(lambda s, t: jlosses.get_loss_DA(s, t, cfg),
                         *jax_end_points)
    _, aux = tlosses.get_loss_DA(*_torch_eps(*jax_end_points), cfg)
    assert "da_loss" in aux
    _check_aux(aux, aux_j)


@pytest.mark.parametrize("epoch", [0, 30, 90])
def test_get_loss_da_jitter_matches_jax(setup, jax_end_points, epoch):
    cfg = setup["cfg"]
    _, aux_j = _jax_loss(
        lambda s, t: jlosses.get_loss_DA_jitter(s, t, np.float32(epoch),
                                                cfg), *jax_end_points)
    ep_S, ep_T = _torch_eps(*jax_end_points)
    for ep in (ep_S, ep_T):
        ep["jitter_pred"].requires_grad_(True)
    loss, aux = tlosses.get_loss_DA_jitter(ep_S, ep_T, epoch, cfg)
    _check_aux(aux, aux_j)
    # the source's prediction is trained; the refined target labels are
    # detached, so no gradient reaches the target's prediction
    loss.backward()
    assert ep_S["jitter_pred"].grad.abs().sum() > 0
    assert ep_T["jitter_pred"].grad is None


@pytest.mark.parametrize("kind", ["da", "da_jitter"])
def test_da_models_end_points_match_jax_f64(setup, kind):
    jitter = kind == "da_jitter"
    batch = setup["batch_T"]
    jax.config.update("jax_enable_x64", True)
    try:
        model = _jax_model(setup, kind)
        want = jax.device_get(jax.jit(
            lambda v, *a: model.apply(v, *a, train=False))(
                _v64(setup["variables"][kind]),
                *map(jnp.asarray, _args(batch, jitter))))
    finally:
        jax.config.update("jax_enable_x64", False)
    port = _port_model(setup, kind).eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, _args(batch, jitter)))
    assert set(got) == set(want)
    for key in sorted(want):
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape, key
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=key)


def test_sa_module_centers_matches_jax_f32():
    """The jitter head's layer: a ball query at r=0.8 around given
    centres (padded rows at the origin), no radius normalization, one MLP
    layer and max pooling, through `group_localize_stratified` at radius
    1.0; its grouping equals the un-normalized one bit for bit."""
    from backtoreality_tpu.nn import SAModuleCenters as JaxSAModuleCenters
    from backtoreality_tpu_torch import ops as port_ops
    from backtoreality_tpu_torch.nn import SAModuleCenters

    rng = np.random.default_rng(11)
    xyz = ((rng.random((2, 512, 3)) * 2 - 1) * 1.5).astype(np.float32)
    feats = rng.normal(size=(2, 512, 16)).astype(np.float32)
    centres = ((rng.random((2, 12, 3)) * 2 - 1) * 1.5).astype(np.float32)
    centres[:, 9:] = 0.0  # padded label rows
    centres[0, 8] = [9.0, 9.0, 9.0]  # a centre with no point in reach
    jmod = JaxSAModuleCenters(radius=0.8, nsample=16, mlp=[32])
    variables = jax.device_get(jmod.init(
        jax.random.PRNGKey(2), jnp.asarray(xyz), jnp.asarray(feats),
        jnp.asarray(centres), train=False))
    want = jmod.apply(variables, jnp.asarray(xyz), jnp.asarray(feats),
                      jnp.asarray(centres), train=False)

    port = SAModuleCenters(radius=0.8, nsample=16, in_features=16,
                           mlp=[32])
    port.load_state_dict(state_dict_from_jax(variables))  # strict
    port.eval()
    x, f, c = map(torch.from_numpy, (xyz, feats, centres))
    with torch.no_grad():
        got = port(x, f, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

    idx, hit = port_ops.ball_query_stratified(x, c, 0.8, 16,
                                              return_hit=True)
    fused = port_ops.group_localize_stratified(x, f, c, idx, hit, 1.0)
    grouped = port_ops.group_points_stratified(torch.cat([x, f], -1), idx,
                                               hit)
    plain = torch.cat([grouped[..., :3] - c[:, :, None, :],
                       grouped[..., 3:]], -1)
    assert torch.equal(fused, plain)


def test_grad_reverse_negates_the_gradient():
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3).requires_grad_()
    y = grad_reverse(x)
    assert torch.equal(y, x)
    (y * torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)).sum().backward()
    assert torch.equal(x.grad, -torch.tensor([[1.0, 2.0, 3.0]] * 2,
                                              dtype=torch.float64))


def _capture_grads():
    """An optax transformation that keeps the gradients as its state and
    leaves the parameters unchanged."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    return optax.GradientTransformation(
        zeros, lambda g, state, params=None: (zeros(g), g))


@pytest.mark.parametrize("kind,epoch", [("da", 0), ("da_jitter", 30)])
def test_da_step_gradients_at_init_match_jax_f64(setup, kind, epoch):
    jitter = kind == "da_jitter"
    cfg = setup["cfg"]
    v64 = _v64(setup["variables"][kind])
    jax.config.update("jax_enable_x64", True)
    try:
        optimizer = _capture_grads()
        state = jcommon.TrainState(
            step=jnp.zeros((), jnp.int32), params=v64["params"],
            batch_stats=v64["batch_stats"],
            opt_state=optimizer.init(v64["params"]))
        step_fn = jax_da_train_step(_jax_model(setup, kind), optimizer, cfg,
                                    jitter=jitter)
        state, aux_j = jax.device_get(step_fn(
            state, *({k: jnp.asarray(v) for k, v in setup[b].items()}
                     for b in ("batch_S", "batch_T")),
            jax.random.PRNGKey(0), np.float64(BN_MOMENTUM),
            np.float32(epoch)))
    finally:
        jax.config.update("jax_enable_x64", False)

    model = _port_model(setup, kind)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = make_da_train_step(model, opt, cfg, jitter=jitter)
    aux = step(to_device(setup["batch_S"], "cpu"),
               to_device(setup["batch_T"], "cpu"), BN_MOMENTUM, epoch)
    _check_aux(aux, aux_j)

    want_grads = state_dict_from_jax({"params": state.opt_state})
    params = dict(model.named_parameters())
    assert set(want_grads) == set(params)
    for name, want in want_grads.items():
        # no loss reads the jitter discriminator: autograd leaves its
        # gradient None where JAX gives zeros
        grad = params[name].grad
        got = np.zeros(want.shape) if grad is None else grad.numpy()
        err = np.linalg.norm(got - want.numpy())
        assert err <= 1e-7 * np.linalg.norm(want.numpy()), name
    # the domain heads' gradient reaches the backbone reversed: it is in
    # the backbone's gradient, and the heads' own are not zero
    assert np.linalg.norm(want_grads["da_heads.global_netD2.weight"]) > 0
    want_stats = state_dict_from_jax({"batch_stats": state.batch_stats})
    buffers = dict(model.named_buffers())
    for name, want in want_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(),
                                   rtol=0, atol=1e-9, err_msg=name)


def test_graft_counts_match_jax(setup):
    """BR weights into the CenterRefine model: the JAX package restores
    params and batch_stats in two calls; the port logs the same counts."""
    said = []
    br, cr = setup["variables"]["da"], setup["variables"]["da_jitter"]
    for coll in ("params", "batch_stats"):
        jcommon.partial_restore(cr[coll], br[coll], log=said.append)
    model = VoteNetDAJitter(mean_size_arr=setup["cfg"].mean_size_arr,
                            **setup["kw"])
    got = []
    tcommon.partial_restore(model, state_dict_from_jax(br),
                              log=got.append)
    assert got == said
    copied = [int(re.search(r"copied (\d+)", s).group(1)) for s in got]
    assert all(n > 0 for n in copied)
    # the copied leaves carry BR's values
    sd = state_dict_from_jax(br)
    np.testing.assert_array_equal(model.state_dict()["pnet.out.weight"],
                                  sd["pnet.out.weight"])


def test_set_bn_momentum_reaches_the_domain_heads(setup):
    model = _port_model(setup, "da_jitter")
    set_bn_momentum(model, 0.25)
    assert model.da_heads.local_netD.bn0.momentum == 0.25
    assert model.jitter_net.bn0.momentum == 0.25
