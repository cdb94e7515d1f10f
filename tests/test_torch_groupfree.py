"""The port's GroupFree3D model and criteria against the JAX package's, on
the CPU.

One labelled batch of synthetic scans with GroupFree3D's labels (B=2,
N=2048, height feature), a small detector (32 queries, 2 decoder layers,
feed-forward width 96) initialised by the JAX package and carried across
by `bridge` strictly. The Pallas kernels run in interpret mode, as the
JAX package's own tests run them.

* `bridge`: every leaf maps, the attention projections reshaped (query,
  key and value kernels (288, 8, 36) and biases (8, 36); the out kernel
  (8, 36, 288)), list items ``name_i`` as ``name.i``.
* The decoder layer against the JAX one in float32, eval mode: relative
  error 1e-5 of the output's largest entry.
* Selection among ties: `top_k_indices` equals ``jax.lax.top_k`` on rows
  full of equal values; the KPS query choice at saturated sigmoid scores
  and the hard top-k labels of boxes with fewer seeds in their instance
  than `topk` (their other seeds tie at 100.0) equal the JAX package's.
* Eval-mode end_points key by key in float64 (both packages): indices
  exactly, floats to atol 1e-9, except the box heads' outputs, which the
  JAX package computes in float32 whatever the model's dtype
  (``PredictHead`` casts its input and runs its heads in float32): those
  to rtol and atol 1e-6. With KPS and with FPS query sampling.
* `get_loss` and `get_loss_weak` on the JAX package's float64 end_points:
  the loss and every aux scalar (each prefix's) to rtol 1e-9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.data.dataset import DetectionDataset
from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.losses import groupfree as jlosses
from backtoreality_tpu.models.groupfree import \
    GroupFreeDetector as JaxGroupFree
from backtoreality_tpu.models.groupfree import \
    TransformerDecoderLayer as JaxDecoderLayer
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.losses import groupfree as tlosses
from backtoreality_tpu_torch.models.groupfree import (GroupFreeDetector,
                                                      TransformerDecoderLayer)
from backtoreality_tpu_torch.ops import top_k_indices

B, N, NUM_PROPOSAL, LAYERS, FFN = 2, 2048, 32, 2, 96
HEAD_PREFIXES = ("proposal_", "0head_", "last_")
LOSS_KW = dict(num_decoder_layers=LAYERS,
               query_points_generator_loss_coef=0.8, obj_loss_coef=0.1,
               box_loss_coef=1.0, sem_cls_loss_coef=0.1,
               query_points_obj_topk=4)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def model_kwargs(cfg, sampling="kps"):
    return dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
                num_size_cluster=cfg.num_size_cluster, input_feature_dim=1,
                num_proposal=NUM_PROPOSAL, num_decoder_layers=LAYERS,
                dim_feedforward=FFN, sampling=sampling,
                self_position_embedding="loc_learned",
                cross_position_embedding="xyz_learned")


def gf_batch(root, cfg, split="all", center_jitter=0.0):
    """B labelled scans with GroupFree3D's labels, float64."""
    ds = DetectionDataset(cfg, root, split=split, num_points=N,
                          use_height=True, gf_labels=True,
                          center_jitter=center_jitter)
    items = [ds.get(i) for i in range(B)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def jax_init(cfg, batch, sampling="kps"):
    """The JAX package's float32 init of the small detector."""
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    model = JaxGroupFree(mean_size_arr=msa, **model_kwargs(cfg, sampling))
    pc = jnp.asarray(batch["point_clouds"][:1], jnp.float32)
    return jax.device_get(jax.jit(
        lambda k, x: model.init(k, x, train=False))(jax.random.PRNGKey(0),
                                                    pc))


def v64(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  variables)


def jax_forward_f64(cfg, variables, batch, sampling="kps", train=False,
                    **extra):
    """The JAX detector's end_points in float64 (x64 on), numpy."""
    jax.config.update("jax_enable_x64", True)
    try:
        msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
        model = JaxGroupFree(mean_size_arr=msa, dtype=jnp.float64,
                             head_dtype=jnp.float64,
                             **model_kwargs(cfg, sampling), **extra)
        out = jax.device_get(jax.jit(
            lambda v, x: model.apply(v, x, train=train))(
                v64(variables), jnp.asarray(batch["point_clouds"])))
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        jax.config.update("jax_enable_x64", False)


def port_model(cfg, variables, sampling="kps", **extra):
    model = GroupFreeDetector(mean_size_arr=cfg.mean_size_arr,
                              **model_kwargs(cfg, sampling), **extra)
    model.load_state_dict(state_dict_from_jax(v64(variables)))  # strict
    return model.double()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = jax_config()
    root = tmp_path_factory.mktemp("torch_gf_scans")
    write_synthetic_scans(root, cfg, num_scans=B, num_objects=4,
                          points_per_object=400, floor_points=800, seed=5)
    batch = gf_batch(root, cfg)
    return dict(cfg=cfg, batch=batch, variables=jax_init(cfg, batch))


@pytest.fixture(scope="module")
def jax_end_points(setup):
    """The JAX detector's eval-mode end_points merged with the labels, all
    floats in float64 (the heads' outputs come in float32)."""
    out = jax_forward_f64(setup["cfg"], setup["variables"], setup["batch"])
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in {**setup["batch"], **out}.items()}


def test_bridge_maps_every_leaf(setup):
    variables = setup["variables"]
    sd = state_dict_from_jax(variables)
    model = GroupFreeDetector(mean_size_arr=setup["cfg"].mean_size_arr,
                              **model_kwargs(setup["cfg"]))
    assert set(sd) == set(model.state_dict())
    attn = variables["params"]["decoder_1"]["cross_attn"]
    np.testing.assert_array_equal(
        sd["decoder.1.cross_attn.query.weight"].numpy(),
        np.asarray(attn["query"]["kernel"]).reshape(288, 288).T)
    np.testing.assert_array_equal(
        sd["decoder.1.cross_attn.value.bias"].numpy(),
        np.asarray(attn["value"]["bias"]).reshape(288))
    np.testing.assert_array_equal(
        sd["decoder.1.cross_attn.out.weight"].numpy(),
        np.asarray(attn["out"]["kernel"]).reshape(288, 288).T)
    mean = variables["batch_stats"]["decoder_self_posembeds_0"]["bn0"]["mean"]
    np.testing.assert_array_equal(
        sd["decoder_self_posembeds.0.bn0.running_mean"].numpy(),
        np.asarray(mean))


def test_decoder_layer_matches_jax_f32():
    rng = np.random.default_rng(0)
    query, query_pos = rng.normal(size=(2, 2, 32, 288)).astype(np.float32)
    key, key_pos = rng.normal(size=(2, 2, 64, 288)).astype(np.float32)
    args = [jnp.asarray(a) for a in (query, key, query_pos, key_pos)]
    jmod = JaxDecoderLayer(288, 8, FFN, 0.1)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(1), *args,
                                         train=False))
    want = np.asarray(jmod.apply(variables, *args, train=False))
    port = TransformerDecoderLayer(288, 8, FFN, 0.1)
    port.load_state_dict(state_dict_from_jax(variables))  # strict
    port.eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (query, key, query_pos,
                                           key_pos))).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    # the position embeddings are optional
    want = np.asarray(jmod.apply(variables, args[0], args[1], None, None,
                                 train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(query), torch.from_numpy(key), None,
                   None).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_top_k_indices_match_xla_among_ties():
    scores = np.array([[0.5, 1, 1, 0.2, 1, 1, 0.9]], np.float32)
    assert top_k_indices(torch.from_numpy(scores), 3).tolist() == [[1, 2, 4]]
    _, want = jax.lax.top_k(jnp.asarray(scores), 3)
    assert np.asarray(want).tolist() == [[1, 2, 4]]
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 5, size=(16, 200)).astype(np.float32)
    for k in (1, 7, 64, 200):
        _, want = jax.lax.top_k(jnp.asarray(rows), k)
        got = top_k_indices(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kps_selection_with_saturated_scores(setup):
    """Seed logits above ~17 saturate the sigmoid to 1.0 in float32: the
    queries are the lowest-index seeds among the saturated ones, as XLA's
    top-k picks them."""
    cfg, variables = setup["cfg"], jax.tree_util.tree_map(
        np.array, setup["variables"])
    # a large objectness bias: every seed's sigmoid rounds to 1.0
    variables["params"]["points_obj_cls"]["out"]["bias"][:] = 40.0
    pc = setup["batch"]["point_clouds"].astype(np.float32)
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    jmodel = JaxGroupFree(mean_size_arr=msa, **model_kwargs(cfg))
    want = jax.device_get(jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False))(variables,
                                                       jnp.asarray(pc)))
    assert (np.asarray(jax.nn.sigmoid(
        want["seeds_obj_cls_logits"])) == 1.0).mean() > 0.5
    port = GroupFreeDetector(mean_size_arr=cfg.mean_size_arr,
                             **model_kwargs(cfg))
    port.load_state_dict(state_dict_from_jax(variables))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(pc))
    np.testing.assert_array_equal(
        got["query_points_sample_inds"].numpy(),
        np.asarray(want["query_points_sample_inds"]))


def test_hard_topk_labels_among_ties_match_jax(jax_end_points):
    """Boxes shrunk to a few seeds each: each box's instance holds fewer
    seeds than `topk` = 64, so its other seeds tie at distance 100.0 and
    the lowest indices among them become positives."""
    ep = dict(jax_end_points)
    inst = ep["point_instance_label"].copy()
    seeds = ep["seed_inds"].astype(np.int64)
    # keep two seeds of each instance, drop the rest to background
    for b in range(B):
        kept = {}
        for s in seeds[b]:
            i = inst[b, s]
            if i >= 0:
                kept[i] = kept.get(i, 0) + 1
                if kept[i] > 2:
                    inst[b, s] = -1
    ep["point_instance_label"] = inst
    topk = 64
    for fn in ("compute_points_obj_cls_loss_hard_topk",
               "compute_points_obj_cls_loss_hard_topk_weak"):
        jax.config.update("jax_enable_x64", True)
        try:
            want = jax.device_get(getattr(jlosses, fn)(
                {k: jnp.asarray(v) for k, v in ep.items()}, topk))
        finally:
            jax.config.update("jax_enable_x64", False)
        got = getattr(tlosses, fn)(
            {k: torch.from_numpy(np.array(v)) for k, v in ep.items()}, topk)
        np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-9)
        for key, value in want[1].items():
            np.testing.assert_allclose(got[1][key].item(), float(value),
                                       rtol=1e-9, err_msg=key)
    # the labels themselves, against a stable numpy selection
    dist = np.full((1, 1, 10), 100.0)
    dist[0, 0, [7, 8]] = [0.5, 0.25]
    label = tlosses._topk_labels(torch.from_numpy(dist),
                                 torch.ones(1, 1), 4)
    assert label.tolist() == [[1, 1, 0, 0, 0, 0, 0, 1, 1, 0]]


@pytest.mark.parametrize("sampling", ["kps", "fps"])
def test_end_points_match_jax_f64(setup, sampling):
    cfg, batch = setup["cfg"], setup["batch"]
    variables = (setup["variables"] if sampling == "kps"
                 else jax_init(cfg, batch, sampling))
    want = jax_forward_f64(cfg, variables, batch, sampling)
    port = port_model(cfg, variables, sampling).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(batch["point_clouds"]))
    assert set(got) == set(want)
    for key in sorted(want):
        g, w = got[key].numpy(), want[key]
        assert g.shape == w.shape, key
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif key.startswith(HEAD_PREFIXES) and key[-8:] != "base_xyz":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=key)


def _check_aux(aux, aux_j):
    scalars = {k: v for k, v in aux_j.items() if np.ndim(v) == 0}
    assert set(scalars) == {k for k, v in aux.items() if v.dim() == 0}
    for key, want in scalars.items():
        np.testing.assert_allclose(aux[key].item(), float(want), rtol=1e-9,
                                   atol=0, err_msg=key)


@pytest.mark.parametrize("name", ["get_loss", "get_loss_weak"])
def test_criteria_match_jax_f64(setup, jax_end_points, name):
    cfg = setup["cfg"]
    ep = dict(jax_end_points)
    if name == "get_loss_weak":
        # weak labels: the centres jittered by a tenth of the box size
        ep["center_label"] = ep["center_label"] + ep["center_jitter"] + 0.1 * (
            ep["size_gts"])
    jax.config.update("jax_enable_x64", True)
    try:
        loss_j, aux_j = jax.device_get(getattr(jlosses, name)(
            {k: jnp.asarray(v) for k, v in ep.items()}, cfg, **LOSS_KW))
    finally:
        jax.config.update("jax_enable_x64", False)
    loss, aux = getattr(tlosses, name)(
        {k: torch.from_numpy(np.array(v)) for k, v in ep.items()}, cfg,
        **LOSS_KW)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-9)
    _check_aux(aux, aux_j)
    for prefix in ("proposal_", "0head_", "last_"):
        assert f"{prefix}objectness_loss" in aux
    if name == "get_loss_weak":
        np.testing.assert_array_equal(aux["_last_objectness_label"].numpy(),
                                      np.asarray(aux_j[
                                          "_last_objectness_label"]))
