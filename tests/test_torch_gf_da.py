"""The port's GroupFree3D BR and BR+CenterRefine slice against the JAX
package's, on the CPU.

The small detector of tests/test_torch_groupfree.py (B=2, N=2048, height
feature, 32 queries, 2 decoder layers, feed-forward width 96), a source
batch from virtual scans (``scene_aug`` under a path holding ``obj``,
split ``train_aug``) and a target batch from real scans, both with
GroupFree3D's labels (unused centres at +1000) and jittered centres. The
Pallas kernels run in interpret mode, as the JAX package's own tests run
them.

* `SAModuleCenters(normalize_xyz=True)` (the GF jitter head's layer)
  against the JAX module in float32, with centres padded at +1000 among
  the given ones: pooled features within 1e-6 of the largest.
* `bridge`: both DA graphs load strictly from the JAX variables.
* Eval-mode end_points of `GroupFreeDetectorDA` and
  `GroupFreeDetectorDAJitter` key by key in float64, to the tolerances of
  tests/test_torch_groupfree.py (the box heads' outputs, which the JAX
  package computes in float32, to 1e-6; the rest, the domain heads and the
  jitter head among them, to atol 1e-9; indices exactly).
* `get_loss_DA` and `get_loss_DA_jitter` (epochs 7, 60 and 150: on the
  ramp, at its middle, past its end) on the JAX package's float64
  end_points: the loss and every aux scalar to rtol 1e-9.
* One DA step at init against the JAX package's `make_da_train_step` with
  an optax transformation that captures the gradients, float64, dropout
  0, for both graphs: aux scalars to rtol 1e-6 (the JAX heads' outputs
  are float32, as above), every gradient within
  1e-6 of its leaf's norm (the domain heads reach the backbone through
  `grad_reverse`), BN running statistics after the source-then-target
  forwards to atol 1e-9 (1e-8 for the query position embeddings').
* The BR -> CenterRefine graft: the counts the JAX package's
  `partial_restore` logs.
* `CALayer` in float32, train and eval mode.
* The pseudo-label suite: `get_pseudo_labels` with `use_lhs` on and off
  gives equal arrays; `get_loss_pseudo` every aux scalar to rtol 1e-9.
* `gf_br.main` and `gf_br_center_refine.main` on the CPU for one epoch on
  2 scans: checkpoints, `Eval_mAP.txt`, and CenterRefine grafted from
  BR's checkpoint with the JAX package's counts in its log.
* `evaluate --model groupfree` on a BR checkpoint written by the JAX
  package: mAP within 0.005 of the JAX `evaluate`, seed by seed.
"""

import argparse
import json
import math
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.losses import groupfree as jlosses
from backtoreality_tpu.models.groupfree import \
    GroupFreeDetectorDA as JaxGFDA
from backtoreality_tpu.models.groupfree import \
    GroupFreeDetectorDAJitter as JaxGFDAJitter
from backtoreality_tpu.train import common as jcommon
from backtoreality_tpu.train import groupfree as jgroupfree
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.data import get_config as port_config
from backtoreality_tpu_torch.losses import groupfree as tlosses
from backtoreality_tpu_torch.models.groupfree import (
    CALayer, GroupFreeDetectorDA, GroupFreeDetectorDAJitter)
from backtoreality_tpu_torch.train import common as tcommon
from backtoreality_tpu_torch.train import (evaluate, gf_br,
                                           gf_br_center_refine, groupfree)
from test_torch_gf_train import (SMALL, _blob_scans, _jax_gf_checkpoint,
                                 lamp_heads)
from test_torch_groupfree import (HEAD_PREFIXES, LAYERS, LOSS_KW, gf_batch,
                                  jax_config, model_kwargs, v64)

BN_MOMENTUM = 0.1
JAX_MODELS = {"da": JaxGFDA, "da_jitter": JaxGFDAJitter}
PORT_MODELS = {"da": GroupFreeDetectorDA,
               "da_jitter": GroupFreeDetectorDAJitter}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _args(batch, jitter):
    keys = ["point_clouds"] + (["center_label", "sem_cls_label"]
                               if jitter else [])
    return [batch[k] for k in keys]


def _msa(cfg):
    return tuple(map(tuple, cfg.mean_size_arr.tolist()))


def _jax_model(cfg, kind, **extra):
    """The JAX DA graph in float64 (the heads too)."""
    return JAX_MODELS[kind](mean_size_arr=_msa(cfg), dtype=jnp.float64,
                            head_dtype=jnp.float64,
                            **{**model_kwargs(cfg), **extra})


def _port_model(setup, kind, **extra):
    model = PORT_MODELS[kind](mean_size_arr=setup["cfg"].mean_size_arr,
                              **{**model_kwargs(setup["cfg"]), **extra})
    model.load_state_dict(state_dict_from_jax(v64(
        setup["variables"][kind])))  # strict
    return model.double()


@pytest.fixture(scope="module")
def virtual(tmp_path_factory):
    """Two virtual scans: ``scene_aug`` names under ``obj_aug``."""
    root = tmp_path_factory.mktemp("torch_gf_da") / "obj_aug"
    write_synthetic_scans(root, jax_config(), num_scans=2, num_objects=4,
                          points_per_object=400, floor_points=800, seed=9,
                          prefix="scene_aug")
    return root


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_gf_da_real")
    write_synthetic_scans(root, jax_config(), num_scans=2, num_objects=4,
                          points_per_object=400, floor_points=800, seed=8)
    return root


@pytest.fixture(scope="module")
def setup(virtual, real):
    """The source and target batches (float64) and both JAX DA graphs'
    float32 inits."""
    cfg = jax_config()
    batch_S = gf_batch(virtual, cfg, split="train_aug", center_jitter=0.1)
    batch_T = gf_batch(real, cfg, center_jitter=0.1)
    assert (batch_T["center_label"] > 900).any()  # GF's padded centres
    variables = {}
    for kind, cls in JAX_MODELS.items():
        model = cls(mean_size_arr=_msa(cfg), **model_kwargs(cfg))
        sample = [jnp.asarray(a[:1], jnp.float32) if a.dtype == np.float64
                  else jnp.asarray(a[:1])
                  for a in _args(batch_T, kind == "da_jitter")]
        variables[kind] = jax.device_get(jax.jit(
            lambda k, *a: model.init(k, *a, train=False))(
                jax.random.PRNGKey(0), *sample))
    return dict(cfg=cfg, batch_S=batch_S, batch_T=batch_T,
                variables=variables)


@pytest.fixture(scope="module")
def jax_end_points(setup):
    """Both graphs' eval-mode end_points on the source and the target
    batch, merged with the labels, all floats float64."""
    out = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for kind in JAX_MODELS:
            model = _jax_model(setup["cfg"], kind)
            fwd = jax.jit(lambda v, *a: model.apply(v, *a, train=False))
            variables = v64(setup["variables"][kind])
            out[kind] = []
            for batch in (setup["batch_S"], setup["batch_T"]):
                ep = jax.device_get(fwd(variables, *map(
                    jnp.asarray, _args(batch, kind == "da_jitter"))))
                merged = {**batch, **{k: np.asarray(v)
                                      for k, v in ep.items()}}
                out[kind].append(
                    {k: v.astype(np.float64) if v.dtype == np.float32
                     else v for k, v in merged.items()})
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


def test_sa_module_centers_normalized_matches_jax_f32():
    """GroupFree3D's jitter head layer: the ball query at r=0.8 around the
    given centres, the local coordinates divided by the radius, one MLP
    layer and max pooling; most centres are padding at +1000 and hit no
    point."""
    from backtoreality_tpu.nn import SAModuleCenters as JaxSAModuleCenters
    from backtoreality_tpu_torch.nn import SAModuleCenters

    rng = np.random.default_rng(12)
    xyz = ((rng.random((2, 512, 3)) * 2 - 1) * 1.5).astype(np.float32)
    feats = rng.normal(size=(2, 512, 24)).astype(np.float32)
    centres = ((rng.random((2, 16, 3)) * 2 - 1) * 1.5).astype(np.float32)
    centres[:, 5:] += 1000.0  # GF's padded label rows
    jmod = JaxSAModuleCenters(radius=0.8, nsample=16, mlp=[32],
                              normalize_xyz=True)
    args = [jnp.asarray(a) for a in (xyz, feats, centres)]
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(3), *args,
                                         train=False))
    want = np.asarray(jmod.apply(variables, *args, train=False))
    port = SAModuleCenters(radius=0.8, nsample=16, in_features=24,
                           mlp=[32], normalize_xyz=True)
    port.load_state_dict(state_dict_from_jax(variables))  # strict
    port.eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (xyz, feats, centres))).numpy()
    # each kind of centre at its own scale: the given ones' features are
    # O(1), the padded ones' (local coordinates near 1250) about 1000
    for rows in (slice(0, 5), slice(5, None)):
        err = np.abs(got[:, rows] - want[:, rows]).max()
        assert err <= 1e-6 * np.abs(want[:, rows]).max(), rows
    # the normalization is on: without it the layer reads otherwise
    plain = SAModuleCenters(radius=0.8, nsample=16, in_features=24,
                            mlp=[32])
    plain.load_state_dict(port.state_dict())
    plain.eval()
    with torch.no_grad():
        other = plain(*map(torch.from_numpy, (xyz, feats, centres))).numpy()
    assert np.abs(other - want).max() > 1e-3


@pytest.mark.parametrize("kind", ["da", "da_jitter"])
def test_bridge_loads_da_graphs_strictly(setup, kind):
    sd = state_dict_from_jax(setup["variables"][kind])
    model = PORT_MODELS[kind](mean_size_arr=setup["cfg"].mean_size_arr,
                              **model_kwargs(setup["cfg"]))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)  # strict
    assert "da_heads.decoder_netD.out.weight" in sd
    assert ("ctjt_head.mlp.bn0.running_mean" in sd) == (kind == "da_jitter")


@pytest.mark.parametrize("kind", ["da", "da_jitter"])
def test_da_end_points_match_jax_f64(setup, jax_end_points, kind):
    jitter = kind == "da_jitter"
    port = _port_model(setup, kind).eval()
    for batch, want in zip((setup["batch_S"], setup["batch_T"]),
                           jax_end_points[kind]):
        with torch.no_grad():
            got = port(*map(torch.from_numpy, _args(batch, jitter)))
        assert set(got) == set(want) - set(batch)
        for name in ("global_d_pred", "last_local_d_pred") + (
                ("center_features", "jitter_pred") if jitter else ()):
            assert name in got
        for key in sorted(got):
            g, w = got[key].numpy(), want[key]
            assert g.shape == w.shape, key
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(g, w, err_msg=key)
            elif key.startswith(HEAD_PREFIXES) and key[-8:] != "base_xyz":
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                           err_msg=key)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-9,
                                           err_msg=key)


def _jax_loss(fn, *eps):
    jax.config.update("jax_enable_x64", True)
    try:
        return jax.device_get(fn(*({k: jnp.asarray(v) for k, v in ep.items()}
                                   for ep in eps)))
    finally:
        jax.config.update("jax_enable_x64", False)


def _torch_eps(*eps):
    return [{k: torch.from_numpy(np.array(v)) for k, v in ep.items()}
            for ep in eps]


def _check_aux(aux, aux_j, rtol=1e-9):
    scalars = {k: v for k, v in aux_j.items() if np.ndim(v) == 0}
    assert set(scalars) == {k for k, v in aux.items()
                            if torch.is_tensor(v) and v.dim() == 0}
    for key, want in scalars.items():
        np.testing.assert_allclose(aux[key].item(), float(want), rtol=rtol,
                                   atol=0, err_msg=key)


@pytest.mark.parametrize("name,epoch", [("get_loss_DA", None),
                                        ("get_loss_DA_jitter", 7),
                                        ("get_loss_DA_jitter", 60),
                                        ("get_loss_DA_jitter", 150)])
def test_da_criteria_match_jax_f64(setup, jax_end_points, name, epoch):
    cfg = setup["cfg"]
    eps = jax_end_points["da_jitter"]
    if epoch is None:
        _, aux_j = _jax_loss(lambda s, t: jlosses.get_loss_DA(
            s, t, cfg, **LOSS_KW), *eps)
        loss, aux = tlosses.get_loss_DA(*_torch_eps(*eps), cfg, **LOSS_KW)
    else:
        # the JAX step's epoch arrives as a float32
        _, aux_j = _jax_loss(lambda s, t: jlosses.get_loss_DA_jitter(
            s, t, np.float32(epoch), cfg, **LOSS_KW), *eps)
        ep_S, ep_T = _torch_eps(*eps)
        for ep in (ep_S, ep_T):
            ep["jitter_pred"].requires_grad_(True)
        loss, aux = tlosses.get_loss_DA_jitter(ep_S, ep_T, epoch, cfg,
                                               **LOSS_KW)
        assert "jitter_loss_S" in aux
        # the refined target labels are detached
        loss.backward()
        assert ep_S["jitter_pred"].grad.abs().sum() > 0
        assert ep_T["jitter_pred"].grad is None
    _check_aux(aux, aux_j)
    assert "da_loss" in aux and "T_last_objectness_loss" in aux


def _capture_grads():
    """An optax transformation that keeps the gradients as its state and
    leaves the parameters unchanged."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    return optax.GradientTransformation(
        zeros, lambda g, state, params=None: (zeros(g), g))


@pytest.mark.parametrize("kind,epoch", [("da", 3), ("da_jitter", 60)])
def test_da_step_gradients_match_jax_f64(setup, kind, epoch):
    jitter = kind == "da_jitter"
    cfg = setup["cfg"]
    variables = v64(setup["variables"][kind])
    jax.config.update("jax_enable_x64", True)
    try:
        optimizer = _capture_grads()
        state = jcommon.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=optimizer.init(variables["params"]))
        step_fn = jgroupfree.make_da_train_step(
            _jax_model(cfg, kind, dropout_rate=0.0), optimizer, cfg,
            LOSS_KW, jitter=jitter)
        state, aux_j = jax.device_get(step_fn(
            state, *({k: jnp.asarray(v) for k, v in setup[b].items()}
                     for b in ("batch_S", "batch_T")),
            jax.random.PRNGKey(0), np.float64(BN_MOMENTUM),
            np.float32(epoch)))
    finally:
        jax.config.update("jax_enable_x64", False)

    model = _port_model(setup, kind, dropout_rate=0.0)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = groupfree.make_da_train_step(model, opt, cfg, LOSS_KW,
                                        jitter=jitter)
    aux = step(tcommon.to_device(setup["batch_S"], "cpu"),
               tcommon.to_device(setup["batch_T"], "cpu"), BN_MOMENTUM,
               epoch)
    # the JAX heads' float32 outputs (held to 1e-6 above) feed the losses
    _check_aux(aux, aux_j, rtol=1e-6)

    want_grads = state_dict_from_jax({"params": state.opt_state})
    params = dict(model.named_parameters())
    assert set(want_grads) == set(params)
    for name, want in want_grads.items():
        grad = params[name].grad
        got = np.zeros(want.shape) if grad is None else grad.numpy()
        err = np.linalg.norm(got - want.numpy())
        assert err <= 1e-6 * np.linalg.norm(want.numpy()) + 1e-12, name
    # the domain heads train, and their reversed gradient reaches the
    # backbone's
    for name in ("da_heads.global_netD2.weight",
                 "da_heads.decoder_netD.out.weight") + (
            ("jitter_net.out.weight", "ctjt_head.mlp.dense0.weight")
            if jitter else ()):
        assert np.linalg.norm(want_grads[name]) > 0, name
    want_stats = state_dict_from_jax({"batch_stats": state.batch_stats})
    buffers = dict(model.named_buffers())
    assert set(want_stats) == set(buffers)
    for name, want in want_stats.items():
        atol = 1e-8 if name.startswith("decoder_self_posembeds") else 1e-9
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(),
                                   rtol=0, atol=atol, err_msg=name)


def _jax_graft_log(setup):
    """What the JAX package logs grafting BR's variables into
    CenterRefine's (params, then batch_stats)."""
    said = []
    br, cr = setup["variables"]["da"], setup["variables"]["da_jitter"]
    for coll in ("params", "batch_stats"):
        jcommon.partial_restore(cr[coll], br[coll], log=said.append)
    return said


def test_graft_counts_match_jax(setup):
    said = _jax_graft_log(setup)
    model = GroupFreeDetectorDAJitter(
        mean_size_arr=setup["cfg"].mean_size_arr,
        **model_kwargs(setup["cfg"]))
    got = []
    fresh = tcommon.partial_restore(
        model, state_dict_from_jax(setup["variables"]["da"]),
        log=got.append)
    assert got == said
    # the jitter head's layers stay fresh, everything else is BR's
    new = [k for k in model.state_dict()
           if k.startswith(("ctjt_head.", "jitter_net."))]
    assert fresh == len(new) > 0
    sd = state_dict_from_jax(setup["variables"]["da"])
    np.testing.assert_array_equal(
        model.state_dict()["da_heads.decoder_netD.out.weight"],
        sd["da_heads.decoder_netD.out.weight"])


GF_CLI_GRAFT = ["partial restore: copied 432 leaves, kept 8 fresh",
                "partial restore: copied 96 leaves, kept 4 fresh"]


def test_graft_counts_at_the_cli_defaults_match_jax():
    """BR into CenterRefine at GroupFree3D's CLI defaults (6 decoder
    layers, width 288), the graphs `chip_smoke.py` trains on the card: the
    port's counts, the JAX package's and the ones that script expects."""
    import functools

    from backtoreality_tpu.train.groupfree import add_flags as jax_flags
    from backtoreality_tpu.train.groupfree import \
        build_model as jax_build_model

    cfg = jax_config()
    flags = jax_flags(argparse.ArgumentParser()).parse_args([])
    rng = np.random.default_rng(0)
    pc = jnp.asarray(rng.random((1, 64, 3)), jnp.float32)
    labels = (jnp.zeros((1, 64, 3), jnp.float32),
              jnp.zeros((1, 64), jnp.int32))
    trees = {}
    for kind, args in (("da", (pc,)), ("da_jitter", (pc, *labels))):
        model = jax_build_model(flags, cfg, kind)
        shapes = jax.eval_shape(functools.partial(model.init, train=False),
                                jax.random.PRNGKey(0), *args)
        trees[kind] = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes)
    said = []
    for coll in ("params", "batch_stats"):
        jcommon.partial_restore(trees["da_jitter"][coll],
                                trees["da"][coll], log=said.append)
    pflags = groupfree.add_flags(argparse.ArgumentParser()).parse_args([])
    pcfg = port_config("scannet_md40")
    br = groupfree.build_model(pflags, pcfg, "da").state_dict()
    got = []
    tcommon.partial_restore(groupfree.build_model(pflags, pcfg, "da_jitter"),
                            br, log=got.append)
    assert got == said == GF_CLI_GRAFT


def test_ca_layer_matches_jax_f32():
    from backtoreality_tpu.models.groupfree import CALayer as JaxCALayer

    rng = np.random.default_rng(4)
    b, n, c = 4, 16, 32
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    jmod = JaxCALayer(channel=c, reduction=8)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(5),
                                         jnp.asarray(x), train=False))
    want, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                               bn_momentum=0.1, mutable=["batch_stats"])
    port = CALayer(c, n, reduction=8)
    port.load_state_dict(state_dict_from_jax(variables))  # strict
    port.train()
    got = port(torch.from_numpy(x))
    assert got.shape == (b, n * c)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    stats = state_dict_from_jax(jax.device_get(mutated))
    for name, w in stats.items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                   w.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = jmod.apply({**variables, **jax.device_get(mutated)},
                      jnp.asarray(x), train=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


PSEUDO_HEAD = ("center", "sem_cls_scores", "objectness_scores",
               "heading_scores", "heading_residuals", "size_scores",
               "size_residuals")


def _pseudo_config(cfg, use_lhs, ep, prefix):
    """Thresholds at the 40th percentile of the teacher head's objectness
    and class confidence (the init's scores sit in a narrow band), so
    that some of its proposals pass and some do not."""
    obj = 1.0 / (1.0 + np.exp(-ep[f"{prefix}objectness_scores"]))
    logits = ep[f"{prefix}sem_cls_scores"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    conf = (probs / probs.sum(-1, keepdims=True)).max(-1)
    return dict(obj_threshold=float(np.quantile(obj, 0.4)),
                cls_threshold=float(np.quantile(conf, 0.4)), nms_iou=0.25,
                use_lhs=use_lhs, use_old_type_nms=False,
                dataset_config=cfg)


@pytest.mark.parametrize("use_lhs", [False, True])
def test_pseudo_labels_match_jax(jax_end_points, use_lhs):
    ep = jax_end_points["da_jitter"][1]
    preds = [ep[f"last_{k}"] for k in PSEUDO_HEAD]
    jcfg, tcfg = jax_config(), port_config("scannet_md40")
    *want, aux_j = jlosses.get_pseudo_labels(
        *preds, _pseudo_config(jcfg, use_lhs, ep, "last_"))
    *got, aux = tlosses.get_pseudo_labels(
        *(torch.from_numpy(np.array(p)) for p in preds),
        _pseudo_config(tcfg, use_lhs, ep, "last_"))
    assert 0 < aux_j["pseudo_gt_ratio"] < 1
    assert aux == aux_j
    assert got[0].shape == (2, 64)  # padded out to MAX_NUM_OBJ
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if use_lhs:  # the NMS drops some of the thresholded proposals
        unsuppressed = jlosses.get_pseudo_labels(
            *preds, _pseudo_config(jcfg, False, ep, "last_"))[0]
        assert want[0].sum() < unsuppressed.sum()


def test_get_loss_pseudo_matches_jax(jax_end_points):
    """The target batch as the student (its first row labeled) and its
    ``0head_`` head as the teacher."""
    ep = dict(jax_end_points["da_jitter"][1],
              supervised_mask=np.array([1, 0]))
    unlabeled = {k: v[1:] for k, v in ep.items()}
    jcfg, tcfg = jax_config(), port_config("scannet_md40")
    kw = dict(num_decoder_layers=LAYERS, box_loss_coef=1.0,
              sem_cls_loss_coef=0.1, teacher_prefix="0head_")
    jax.config.update("jax_enable_x64", True)
    try:
        jep = {k: jnp.asarray(v) for k, v in ep.items()}
        loss_j, aux_j = jax.device_get(jlosses.get_loss_pseudo(
            jep, jep, jcfg, _pseudo_config(jcfg, True, unlabeled, "0head_"),
            **kw))
    finally:
        jax.config.update("jax_enable_x64", False)
    (tep,) = _torch_eps(ep)
    loss, aux = tlosses.get_loss_pseudo(
        tep, tep, tcfg, _pseudo_config(tcfg, True, unlabeled, "0head_"),
        **kw)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-9)
    _check_aux({k: v for k, v in aux.items() if k != "pseudo_gt_ratio"},
               {k: v for k, v in aux_j.items() if k != "pseudo_gt_ratio"})
    assert aux["pseudo_gt_ratio"] == aux_j["pseudo_gt_ratio"] > 0
    np.testing.assert_array_equal(aux["unlabeled_objectness_label"].numpy(),
                                  np.asarray(aux_j[
                                      "unlabeled_objectness_label"]))


def _da_args(real, virtual, log):
    return ["--data_root", str(real), "--source_data_root", str(virtual),
            "--train_split", "all", "--val_split", "all", "--log_dir",
            str(log), "--max_epoch", "1", "--val_freq", "1", "--device",
            "cpu", *SMALL]


def test_gf_br_and_center_refine_mains(setup, real, virtual, tmp_path):
    """One epoch (one step of 2 + 2 scenes) and an evaluation each; the
    CenterRefine run grafts BR's checkpoint, the jitter head fresh."""
    br_log, cr_log = tmp_path / "br", tmp_path / "cr"
    model, _ = gf_br.main(_da_args(real, virtual, br_log))
    assert isinstance(model, GroupFreeDetectorDA)
    gf_br_center_refine.main(
        _da_args(real, virtual, cr_log)
        + ["--checkpoint_path", str(br_log / "ckpt_epoch_last.tar")])
    for log in (br_log, cr_log):
        rows = [json.loads(line) for line in
                (log / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in rows if "loss" in r]
        assert len(train) == 1 and math.isfinite(train[0]["loss"])
        assert "da_loss" in train[0] and "T_last_center_loss" in train[0]
        evals = [r for r in rows if r.get("kind") == "eval"]
        assert len(evals) == 1 and math.isfinite(evals[0]["mAP@0.25"])
        assert tcommon.load_checkpoint(
            log / "ckpt_epoch_last.tar")["epoch"] == 0
        lines = (log / "Eval_mAP.txt").read_text().splitlines()
        assert len(lines) == 1 and lines[0].startswith("0\t")
    assert "jitter_loss_S" in json.loads(
        (cr_log / "metrics.jsonl").read_text().splitlines()[0])
    text = (cr_log / "log_train.txt").read_text()
    restores = re.findall(r"partial restore: .*", text)
    assert restores == _jax_graft_log(setup)
    assert "grafted checkpoint" in text


def test_evaluate_groupfree_scores_a_jax_br_checkpoint(setup, tmp_path,
                                                       capsys):
    """A BR checkpoint written by the JAX package (its init with the last
    head made to find the lamps of `_blob_scans`): the plain graph's
    evaluation ignores the domain heads in both packages."""
    from backtoreality_tpu.train import evaluate as jevaluate

    cfg = setup["cfg"]
    lamp = cfg.type2class["lamp"]
    scans = _blob_scans(tmp_path / "scans", cfg, lamp)
    variables = jax.tree_util.tree_map(np.array, setup["variables"]["da"])
    lamp_heads(variables["params"], lamp)
    ckpt = _jax_gf_checkpoint(dict(variables=variables),
                              tmp_path / "gf_br.msgpack")
    args = ["--model", "groupfree", "--checkpoint_path", str(ckpt),
            "--data_root", str(scans), "--split", "all", "--eval_seeds",
            "2", *SMALL, "--sampling", "fps"]
    capsys.readouterr()
    jevaluate.main(args + ["--num_devices", "1"])
    out = capsys.readouterr().out
    want = [[float(v) for v in m.group(1).split()] for m in re.finditer(
        r"^  mAP: .*\(seeds: ([0-9. ]+)\)$", out, re.M)]
    results = evaluate.main(args + ["--device", "cpu"])
    got = [[r["mAP"] for r in results[("last_", t)]["seeds"]]
           for t in (0.25, 0.5)]
    assert len(want) == 2 and len(want[0]) == 2
    assert min(want[0]) > 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=0.005)
