"""The port's bfloat16 compute (``--bf16``, ``--f32_tail N``) against
the JAX package's, on the CPU (recalibration and the determinism switch:
tests/test_torch_recal.py).

Small widths, as tests/test_torch_da.py: B=1, N=1024 and 16 proposals
for the dtype map, B=2 and N=2048 for the forwards; GroupFree3D with 32
queries, 2 decoder layers and a feed-forward width of 96.

* The dtype map: for VoteNet and GroupFree3D in their plain, da and
  da_jitter graphs and for f32_tail 0, 1, 2, 4 and 6, the dtype of every
  end_points entry and of every backbone stage's output equals the JAX
  package's (`jax.eval_shape`, no compile): the last f32_tail stages in
  float32, the rest and the heads as the JAX package puts them.
* bfloat16 forwards with bridged weights, eval mode: the VoteNet backbone
  (f32_tail 0 and 2) and the GroupFree3D decoder layer. Every output within
  1e-2 of its largest magnitude (2.6 bfloat16 ulps), and the port rounding
  where the JAX package rounds: ``|port_bf16 - jax_bf16| <= 0.25 *
  |port_f32 - jax_bf16|`` (Frobenius norms; port_f32 is the same weights
  in float32) for the decoder layer, the set-abstraction stages, and fp2
  where it runs in float32 (f32_tail 2). fp2 in bfloat16 is held to the
  1e-2 bound only: the FP layers' inverse-distance weights at coincident
  points already differ by ~4e-3 in float32 (tests/test_torch_votenet.py),
  and bfloat16 rounding spreads that (0.35 measured).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.data.dataset import DetectionDataset as JaxDataset
from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.models import groupfree as jgf
from backtoreality_tpu.models import votenet as jvn
from backtoreality_tpu.models.votenet.backbone import \
    Pointnet2Backbone as JaxBackbone
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.models import groupfree as tgf
from backtoreality_tpu_torch.models import votenet as tvn
from backtoreality_tpu_torch.models.votenet.backbone import Pointnet2Backbone

B, N = 2, 2048
GF_SMALL = dict(num_proposal=32, num_decoder_layers=2, dim_feedforward=96)
TAILS = (0, 1, 2, 4, 6)
KINDS = ("plain", "da", "da_jitter")
JAX_VOTENET = {"plain": jvn.VoteNet, "da": jvn.VoteNetDA,
               "da_jitter": jvn.VoteNetDAJitter}
PORT_VOTENET = {"plain": tvn.VoteNet, "da": tvn.VoteNetDA,
                "da_jitter": tvn.VoteNetDAJitter}
JAX_GF = {"plain": jgf.GroupFreeDetector, "da": jgf.GroupFreeDetectorDA,
          "da_jitter": jgf.GroupFreeDetectorDAJitter}
PORT_GF = {"plain": tgf.GroupFreeDetector, "da": tgf.GroupFreeDetectorDA,
           "da_jitter": tgf.GroupFreeDetectorDAJitter}
STAGES = ("sa1", "sa2", "sa3", "sa4", "fp1", "fp2")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_precision_scans")
    write_synthetic_scans(d, jax_config(), num_scans=4, num_objects=4,
                          points_per_object=400, floor_points=800, seed=6)
    return d


def _kw(cfg, model, **extra):
    kw = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
              num_size_cluster=cfg.num_size_cluster, input_feature_dim=1,
              **extra)
    if model == "groupfree":
        kw.update(GF_SMALL)
    return kw


def _batch(root, cfg, n=N, b=B, gf=False):
    """The first `b` scans, float32 (GroupFree3D's labels with `gf`)."""
    ds = JaxDataset(cfg, root, split="all", num_points=n, use_height=True,
                    gf_labels=gf)
    items = [ds.get(i) for i in range(b)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _args(batch, kind):
    keys = ["point_clouds"] + (["center_label", "sem_cls_label"]
                               if kind == "da_jitter" else [])
    return [batch[k] for k in keys]


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# the dtype map
# ---------------------------------------------------------------------------


def _jax_dtypes(model, args):
    """end_points' dtypes and each backbone stage's output dtype, traced
    by `jax.eval_shape`."""

    def run(*a):
        variables = model.init(jax.random.PRNGKey(0), *a, train=False)
        return model.apply(variables, *a, train=False,
                           capture_intermediates=True,
                           mutable=["intermediates"])

    out, inter = jax.eval_shape(run, *args)
    backbone = inter["intermediates"]["backbone_net"]
    backbone = backbone.get("backbone", backbone)  # the jitter model's
    stages = {}
    for stage in STAGES:
        y = backbone[stage]["__call__"][0]
        # SA modules return (xyz, features, inds)
        stages[stage] = str((y[1] if isinstance(y, tuple) else y).dtype)
    return {k: str(v.dtype) for k, v in out.items()}, stages


def _port_dtypes(model, args):
    backbone = model.backbone_net
    backbone = getattr(backbone, "backbone", backbone)
    stages = {}
    for stage in STAGES:
        getattr(backbone, stage).register_forward_hook(
            lambda m, i, y, stage=stage: stages.__setitem__(
                stage, _name((y[1] if isinstance(y, tuple) else y).dtype)))
    with torch.inference_mode():
        out = model(*map(torch.from_numpy, args))
    return {k: _name(v.dtype) for k, v in out.items()}, stages


@pytest.mark.parametrize("f32_tail", TAILS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", ["votenet", "groupfree"])
def test_dtype_map_matches_jax(scans, model, kind, f32_tail):
    cfg = jax_config()
    batch = _batch(scans, cfg, n=1024, b=1)
    args = _args(batch, kind)
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    kw = _kw(cfg, model, f32_tail=f32_tail)
    if model == "votenet":
        kw["num_proposal"] = 16
        jax_model, port_cls = JAX_VOTENET[kind], PORT_VOTENET[kind]
    else:
        jax_model, port_cls = JAX_GF[kind], PORT_GF[kind]
    want = _jax_dtypes(jax_model(mean_size_arr=msa, dtype=jnp.bfloat16,
                                 **kw), [jnp.asarray(a) for a in args])
    port = port_cls(mean_size_arr=cfg.mean_size_arr, dtype=torch.bfloat16,
                    **kw).eval()
    got = _port_dtypes(port, args)
    assert got[1] == want[1]
    assert got[0] == want[0]
    # the tail really is float32, the rest bfloat16
    assert [got[1][s] for s in STAGES] == [
        "float32" if 6 - i <= f32_tail else "bfloat16" for i in range(6)]


# ---------------------------------------------------------------------------
# bfloat16 forwards
# ---------------------------------------------------------------------------


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ratio(got_bf16, got_f32, want):
    """|port_bf16 - jax_bf16| / |port_f32 - jax_bf16|: well below 1 when
    the port rounds where the JAX package does."""
    return float(np.linalg.norm(got_bf16 - want)
                 / np.linalg.norm(got_f32 - want))


@pytest.mark.parametrize("f32_tail", [0, 2])
def test_backbone_bf16_matches_jax(scans, f32_tail):
    cfg = jax_config()
    pc = _batch(scans, cfg)["point_clouds"]
    jmodel = JaxBackbone(input_feature_dim=1, dtype=jnp.bfloat16,
                         f32_tail=f32_tail)
    variables = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(pc[:1]), train=False))
    want = jax.device_get(jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False))(variables,
                                                      jnp.asarray(pc)))
    outs = {}
    for dtype in (torch.bfloat16, None):
        port = Pointnet2Backbone(input_feature_dim=1, dtype=dtype,
                                 f32_tail=f32_tail)
        port.load_state_dict(state_dict_from_jax(variables))  # strict
        port.eval()
        with torch.no_grad():
            outs[dtype] = port(torch.from_numpy(pc))
    for key in ("sa1_features", "sa2_features", "sa3_features",
                "sa4_features", "fp2_features"):
        w = np.asarray(want[key]).astype(np.float32)
        got = outs[torch.bfloat16][key]
        assert _name(got.dtype) == str(want[key].dtype), key
        got = got.float().numpy()
        assert _rel(got, w) <= 1e-2, (key, _rel(got, w))
        if key != "fp2_features" or f32_tail >= 1:
            ratio = _ratio(got, outs[None][key].float().numpy(), w)
            assert ratio <= 0.25, (key, ratio)


def test_decoder_layer_bf16_matches_jax():
    rng = np.random.default_rng(0)
    query, query_pos = rng.normal(size=(2, 2, 32, 288)).astype(np.float32)
    key, key_pos = rng.normal(size=(2, 2, 64, 288)).astype(np.float32)
    args = [jnp.asarray(a) for a in (query, key, query_pos, key_pos)]
    jmod = jgf.TransformerDecoderLayer(288, 8, 96, 0.1, dtype=jnp.bfloat16)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(1), *args,
                                         train=False))
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
        variables, *args)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want).astype(np.float32)
    outs = {}
    for dtype in (torch.bfloat16, None):
        port = tgf.TransformerDecoderLayer(288, 8, 96, 0.1, dtype=dtype)
        port.load_state_dict(state_dict_from_jax(variables))  # strict
        port.eval()
        with torch.no_grad():
            outs[dtype] = port(*map(torch.from_numpy, (query, key,
                                                       query_pos, key_pos)))
    assert outs[torch.bfloat16].dtype == torch.bfloat16
    got = outs[torch.bfloat16].float().numpy()
    assert _rel(got, want) <= 1e-2, _rel(got, want)
    ratio = _ratio(got, outs[None].float().numpy(), want)
    assert ratio <= 0.25, ratio
