"""The port's data parallelism against one device and against the JAX
package's mesh, on the CPU, in float64.

Two ranks over gloo (spawned processes, tests/torch_parallel_ranks.py).
The train steps take a global batch of 2 rows, one a rank (N=2048,
height feature, 64 proposals; GroupFree3D: 32 queries, 2 decoder layers):
a float64 VoteNet step on 4 rows takes 20 s of this CPU, on each of three
processes. BatchNorm alone and the evaluation take more rows. Each
quantity is
held against the port's one-process run on the 4 rows and against the
JAX package's step jitted over ``make_mesh(2)`` with the batch sharded
(as tests/test_train.py runs it), within a tolerance of each tensor's
largest magnitude:

* BatchNorm's train-mode outputs and running statistics on 2 + 2 rows:
  1e-12 against both (the input's and the parameters' gradients against
  one process).
* One VoteNet FSB step and one BR step (BN through both domains): the
  loss, every gradient summed over the ranks, the BN buffers: 1e-9
  against both. The FSB batch's rows hold different numbers of positive
  proposals (3 GT centres of the first row are moved onto its proposals),
  and the mean of the rows' own losses (the criterion on one rank's rows,
  as a per-rank DDP would average it) misses the global loss by far more
  than the tolerance: the comparison can see a criterion that is not the
  global batch's.
* One GroupFree3D FSB step, dropout 0, GF's optimizer at learning rate 0
  with its clip at 0.1 (after the sum over the ranks): 1e-9 against one
  process; against the JAX mesh step with the tolerances of
  tests/test_torch_gf_train.py (the JAX heads compute in float32), the BN
  buffers of every layer after the proposal head at 1e-8.
* The evaluation with every rank running its rows of each batch (a batch
  of 3 rows, 2 + 1, and one of 1 row, which leaves rank 1 without rows):
  the mAP and AR equal one process's exactly, the eval loss means within
  1e-12.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.data.dataset import DetectionDataset
from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.losses import groupfree as jgf_losses
from backtoreality_tpu.losses import votenet as jlosses
from backtoreality_tpu.models.groupfree import \
    GroupFreeDetector as JaxGroupFree
from backtoreality_tpu.models.votenet import VoteNet as JaxVoteNet
from backtoreality_tpu.models.votenet.da import VoteNetDA as JaxVoteNetDA
from backtoreality_tpu.nn import norm as jnorm
from backtoreality_tpu.parallel import make_mesh, replicate, shard_batch
from backtoreality_tpu.train import common as jcommon
from backtoreality_tpu.train import groupfree as jgroupfree
from backtoreality_tpu.train import votenet as jvotenet
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.losses import votenet as tlosses
from backtoreality_tpu_torch.train import common
from torch_parallel_ranks import CASES, _numpy, enter, step_job
from test_torch_groupfree import LOSS_KW, v64
from test_torch_groupfree import model_kwargs as gf_model_kwargs

ROWS, N, NUM_PROPOSAL, WORLD = 2, 2048, 64, 2
BN_MOMENTUM = 0.1
CLIP = 0.1
RANKS_TIMEOUT = 240  # seconds for the spawned ranks, start to finish


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _batch(roots, cfg, split, rows=ROWS, **kw):
    """`rows` scans, as many from each of `roots` in turn; float64."""
    sets = [DetectionDataset(cfg, root, split=split, num_points=N,
                             use_height=True, **kw) for root in roots]
    items = [sets[i * len(sets) // rows].get(i % (rows // len(sets)))
             for i in range(rows)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def _jax_init(model, batch):
    return jax.device_get(jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(0),
        jnp.asarray(batch["point_clouds"][:1], jnp.float32)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The batches (the FSB batch's first row from a scan with 6 objects,
    3 of them moved onto proposals, its second from a scan with 1), the
    JAX inits, float64."""
    cfg = jax_config()
    base = tmp_path_factory.mktemp("torch_parallel")
    many, few, virtual = base / "many", base / "few", base / "obj_aug"
    for root, scans, objects, seed, prefix in (
            (many, 2, 6, 2, "scene"), (few, 2, 1, 3, "scene"),
            (virtual, ROWS, 4, 4, "scene_aug")):
        write_synthetic_scans(root, cfg, num_scans=scans,
                              num_objects=objects, points_per_object=400,
                              floor_points=800, seed=seed, prefix=prefix)
    fsb = _batch([many, few], cfg, "all")
    br_S = _batch([virtual], cfg, "train_aug")
    br_T = _batch([many, few], cfg, "all", center_jitter=0.1)
    gf = _batch([many, few], cfg, "all", gf_labels=True)
    val = _batch([many, few], cfg, "all", rows=4)
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    vn_kw = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
                 num_size_cluster=cfg.num_size_cluster, input_feature_dim=1,
                 num_proposal=NUM_PROPOSAL)
    variables = {
        "vn": _jax_init(JaxVoteNet(mean_size_arr=msa, **vn_kw), fsb),
        "br": _jax_init(JaxVoteNetDA(mean_size_arr=msa, **vn_kw), fsb),
        "gf": _jax_init(JaxGroupFree(mean_size_arr=msa,
                                     **gf_model_kwargs(cfg)), gf)}
    _onto_proposals(fsb, variables["vn"], vn_kw)
    rng = np.random.default_rng(0)
    return dict(cfg=cfg, msa=msa, vn_kw=vn_kw, variables=variables,
                fsb=fsb, br_S=br_S, br_T=br_T, gf=gf, val=val,
                bn_x=rng.normal(2.0, 3.0, (4, 64, 16)),
                bn_w=rng.normal(size=(4, 64, 16)))


def _onto_proposals(batch, variables, vn_kw):
    """Move the first row's first 3 GT centres onto 3 of its train-mode
    proposals (the step's own: BN on the whole batch), so that row holds
    positive proposals; the second row keeps its one object."""
    from backtoreality_tpu_torch.models.votenet import VoteNet

    cfg = get_config("scannet_md40")
    model = VoteNet(mean_size_arr=cfg.mean_size_arr, **vn_kw)
    model.load_state_dict(state_dict_from_jax(v64(variables)))
    model.double().train()
    with torch.no_grad():
        proposals = model(torch.from_numpy(batch["point_clouds"]))[
            "aggregated_vote_xyz"].numpy()
    batch["center_label"][0, :3] = proposals[0, [0, 20, 40]]


def _inputs(setup):
    """What every case reads, as the ranks load it."""
    cfg = get_config("scannet_md40")
    fsb = setup["fsb"]
    return dict(
        cfg=cfg, mean_size_arr=cfg.mean_size_arr, vn_kw=setup["vn_kw"],
        gf_kw=gf_model_kwargs(cfg), gf_loss_kw=LOSS_KW, clip=CLIP,
        bn_momentum=BN_MOMENTUM, bn_x=setup["bn_x"], bn_w=setup["bn_w"],
        fsb_batch=fsb, br_S=setup["br_S"], br_T=setup["br_T"],
        gf_batch=setup["gf"],
        val_batches=[{k: v[:3] for k, v in setup["val"].items()},
                     {k: v[3:] for k, v in setup["val"].items()}],
        **{f"{name}_state": state_dict_from_jax(v64(setup["variables"][name]))
           for name in ("vn", "br", "gf")})


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Every case at world 2 (rank 0's and rank 1's outputs) and, while
    the ranks run, in this process at world 1 on the whole batch; the FSB
    step's criterion there also takes each row's own loss."""
    d = tmp_path_factory.mktemp("torch_parallel_runs")
    inp = _inputs(setup)
    torch.save(inp, d / "inputs.pt")
    own = []

    def criterion(ep, cfg):
        with torch.no_grad():
            own.extend(tlosses.get_loss(
                {k: v[r:r + 1] for k, v in ep.items()}, cfg)
                for r in range(ROWS))
        return tlosses.get_loss(ep, cfg)

    def world1():
        return {name: _numpy(case(dict(inp, criterion=criterion)))
                for name, case in CASES.items()}

    world1 = common.spawn(enter, WORLD, step_job, (
        str(d / "inputs.pt"), str(d), list(CASES)), timeout=RANKS_TIMEOUT,
        meanwhile=world1)
    world2 = [torch.load(d / f"rank{r}.pt", weights_only=False)
              for r in range(WORLD)]
    return world1, world2, own


def _close(got, want, tol, what, floor=0.0):
    """`got` within `tol` of `want`'s largest magnitude (or of `floor`,
    where that is larger)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    scale = max(np.abs(want).max(initial=0.0), floor)
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol} x {scale:.3g}"


def _close_tree(got, want, tol, what):
    assert set(got) == set(want), what
    for key in want:
        _close(got[key], want[key], tol, f"{what} {key}")


def _mesh_run(fn):
    """`fn(mesh)` with x64 on; the result on the host."""
    jax.config.update("jax_enable_x64", True)
    try:
        return jax.device_get(fn(make_mesh(WORLD)))
    finally:
        jax.config.update("jax_enable_x64", False)


def _capture_grads():
    """An optax transformation that keeps the gradients as its state and
    leaves the parameters unchanged."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    return optax.GradientTransformation(
        zeros, lambda g, state, params=None: (zeros(g), g))


def _jax_step(variables, optimizer, make_step, *batches, extra=()):
    """One JAX train step on the mesh from `variables` (float64): the aux
    scalars, the gradients `optimizer` captured (port names) and the BN
    statistics."""

    def run(mesh):
        state = jcommon.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=optimizer.init(variables["params"]))
        state, aux = make_step(optimizer)(
            replicate(state, mesh), *(shard_batch(b, mesh) for b in batches),
            jax.random.PRNGKey(0), np.float64(BN_MOMENTUM), *extra)
        return state, aux

    state, aux = _mesh_run(run)
    captured = state.opt_state  # the capture's state, last in a chain
    if isinstance(captured, tuple):
        captured = captured[-1]
    grads = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": captured}).items()}
    stats = {k: v.numpy() for k, v in state_dict_from_jax(
        {"batch_stats": state.batch_stats}).items()}
    return {k: float(v) for k, v in aux.items() if np.ndim(v) == 0}, grads, \
        stats


def _check_step(got, want, tol, what, grad_names=None):
    """aux loss, gradients (a parameter without one counts zeros) and BN
    buffers of `got` (a case's output) against `want` (aux, grads,
    stats). A gradient that is zero but for rounding (GroupFree3D's
    attention key biases: the softmax ignores a shift of every key) is
    held against 1e-6 of the model's largest gradient instead."""
    aux, grads, stats = want
    _close(got["aux"]["loss"], aux["loss"], tol, f"{what} loss")
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    for name, g in grads.items():
        _close(got["grads"].get(name, np.zeros_like(g)), g, tol,
               f"{what} grad {name}", floor)
    assert set(got["grads"]) <= set(grads), what
    for name, s in stats.items():
        _close(got["buffers"][name], s, tol, f"{what} buffer {name}")


def _ranks_agree(world2, name):
    """Both ranks hold the same loss, gradients and buffers."""
    a, b = world2[0][name], world2[1][name]
    assert a["aux"]["loss"] == b["aux"]["loss"], name
    for part in ("grads", "buffers"):
        assert set(a[part]) == set(b[part])
        for key in a[part]:
            np.testing.assert_array_equal(a[part][key], b[part][key],
                                          err_msg=f"{name} {part} {key}")


def test_bn_global_moments(setup, runs):
    world1, world2, _ = runs
    x = setup["bn_x"]

    def run(mesh):
        bn = jnorm.BatchNorm(features=x.shape[-1])
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            bn.init(jax.random.PRNGKey(0), x[:1], train=False))
        fn = jax.jit(lambda v, x: bn.apply(v, x, train=True,
                                           momentum=BN_MOMENTUM,
                                           mutable=["batch_stats"]))
        return fn(variables, jax.device_put(x, NamedSharding(mesh,
                                                             P("data"))))

    y_jax, mut = _mesh_run(run)
    y2 = np.concatenate([world2[r]["bn"]["y"] for r in range(WORLD)])
    x_grad2 = np.concatenate([world2[r]["bn"]["x_grad"] for r in range(WORLD)])
    for want, what in ((world1["bn"]["y"], "port"), (y_jax, "jax")):
        _close(y2, want, 1e-12, f"bn output vs {what}")
    stats = mut["batch_stats"]
    for key, jkey in (("running_mean", "mean"), ("running_var", "var")):
        for r in range(WORLD):
            _close(world2[r]["bn"][key], world1["bn"][key], 1e-12, key)
            _close(world2[r]["bn"][key], stats[jkey], 1e-12, f"jax {key}")
    _close(x_grad2, world1["bn"]["x_grad"], 1e-12, "bn input grad")
    for key in ("weight_grad", "bias_grad"):
        _close(world2[0]["bn"][key], world1["bn"][key], 1e-12, key)


def test_votenet_fsb_step(setup, runs):
    world1, world2, _ = runs
    _ranks_agree(world2, "votenet_fsb")
    want = _jax_step(
        v64(setup["variables"]["vn"]), _capture_grads(),
        lambda opt: jvotenet.make_train_step(
            JaxVoteNet(mean_size_arr=setup["msa"], dtype=jnp.float64,
                       head_dtype=jnp.float64, **setup["vn_kw"]),
            opt, jlosses.get_loss, setup["cfg"]),
        setup["fsb"])
    one = world1["votenet_fsb"]
    _check_step(world2[0]["votenet_fsb"],
                (one["aux"], one["grads"], one["buffers"]), 1e-9, "port")
    _check_step(world2[0]["votenet_fsb"], want, 1e-9, "jax mesh")

    # the control: the rows hold different numbers of positive proposals,
    # and the mean of their own losses is not the global loss
    own = [(loss.item(), aux["pos_ratio"].item()) for loss, aux in runs[2]]
    assert own[0][1] > 0 and own[1][1] != own[0][1], own
    glob = float(world2[0]["votenet_fsb"]["aux"]["loss"])
    mean = np.mean([loss for loss, _ in own])
    assert abs(mean - glob) > 1e3 * 1e-9 * abs(glob), (mean, glob)


def test_votenet_br_step(setup, runs):
    world1, world2, _ = runs
    _ranks_agree(world2, "votenet_br")
    want = _jax_step(
        v64(setup["variables"]["br"]), _capture_grads(),
        lambda opt: jvotenet.make_da_train_step(
            JaxVoteNetDA(mean_size_arr=setup["msa"], dtype=jnp.float64,
                         head_dtype=jnp.float64, **setup["vn_kw"]),
            opt, setup["cfg"]),
        setup["br_S"], setup["br_T"], extra=(np.float32(0),))
    one = world1["votenet_br"]
    _check_step(world2[0]["votenet_br"],
                (one["aux"], one["grads"], one["buffers"]), 1e-9, "port")
    _check_step(world2[0]["votenet_br"], want, 1e-9, "jax mesh")


def test_gf_fsb_step(setup, runs):
    world1, world2, _ = runs
    _ranks_agree(world2, "gf_fsb")
    one = world1["gf_fsb"]
    got = world2[0]["gf_fsb"]
    _check_step(got, (one["aux"], one["grads"], one["buffers"]), 1e-9,
                "port")
    aux, grads, stats = _jax_step(
        v64(setup["variables"]["gf"]),
        optax.chain(optax.clip_by_global_norm(CLIP), _capture_grads()),
        lambda opt: jgroupfree.make_train_step(
            JaxGroupFree(mean_size_arr=setup["msa"], dtype=jnp.float64,
                         head_dtype=jnp.float64, dropout_rate=0.0,
                         **gf_model_kwargs(setup["cfg"])),
            opt, jgf_losses.get_loss, setup["cfg"], LOSS_KW),
        setup["gf"])
    # the clip is on: the global norm before it exceeds CLIP
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    assert norm == pytest.approx(CLIP, rel=1e-6)
    np.testing.assert_allclose(got["aux"]["loss"], aux["loss"], rtol=1e-7)
    for name, want in grads.items():
        g = got["grads"].get(name, np.zeros_like(want))
        assert (np.linalg.norm(g - want)
                <= 1e-6 * np.linalg.norm(want) + 1e-12), name
    for name, want in stats.items():
        # the layers after the proposal head read the float32 heads' boxes
        atol = 1e-8 if name.startswith(("decoder", "prediction_heads")) \
            else 1e-9
        np.testing.assert_allclose(got["buffers"][name], want, rtol=0,
                                   atol=atol, err_msg=name)


def test_evaluation_gathers_rows(runs):
    world1, world2, _ = runs
    for r in range(WORLD):
        got, want = world2[r]["eval"], world1["eval"]
        assert (got["mAP"], got["AR"]) == (want["mAP"], want["AR"])
        _close_tree(got["means"], want["means"], 1e-12, "eval loss means")
