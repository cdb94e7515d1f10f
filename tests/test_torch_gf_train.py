"""The port's GroupFree3D training and serving slice against the JAX
package's, on the CPU; and warm starts from the JAX package's
checkpoints.

The small detector and batch of tests/test_torch_groupfree.py (B=2,
N=2048, height feature, 32 queries, 2 decoder layers, feed-forward
width 96), dropout 0 so that a train step is deterministic.

* One FSB train step at init against `make_train_step` with an optax
  transformation that captures the gradients, float64, where the JAX
  heads still run in float32 (``PredictHead``): the loss and aux scalars
  to rtol 1e-7, every parameter gradient within 1e-6 of its leaf's norm,
  the BN running statistics after the step to atol 1e-9 (1e-8 for the
  query position embeddings', whose inputs are those heads' boxes).
* The GF optimizer (global-norm clip 0.1 over every gradient, AdamW with
  weight decay 5e-4 in two groups, the decoder's at its own learning
  rate, warmup schedules) against the JAX package's `make_gf_optimizer`
  with its optax schedules, fed the same gradients for 4 steps, float64:
  each parameter's distance from its start to rtol 2e-5 and atol 2e-9,
  since optax evaluates its schedules in float32 (the warmup's first
  rate, 4e-5 = 4e-3 - (4e-3 - 4e-5), is off by 5e-10 there). The schedules
  equal the JAX ones at every count, and so does the rate the optimizer
  applies, which the loop logs (to rtol 1e-6 and atol 1e-9: optax's are
  float32).
* `gf_fsb.main` trains two epochs on a 2-scan fixture with
  ``--device cpu``, evaluates, writes checkpoints that `evaluate --model
  groupfree` loads, and resumes at the next epoch with the optimizer's
  state and counts; `gf_wsb.main` trains an epoch, and so does
  `gf_fsb.main --query_mode exact`, and with each operations flag of the
  JAX trainer; a run of any recipe without a card is refused unless the
  CPU is asked for.
* `evaluate --model groupfree --device cpu` on a checkpoint written by
  the JAX package's `save_checkpoint` (its init, the last head made to
  find the objects of a 4-scan fixture; JAX mAP@0.25 above 0.02): mAP
  within 0.005 of the JAX package's `evaluate`, seed by seed, over 2
  subsample seeds.
* `votenet_fsb` (and `gf_fsb`) warm-start from a JAX msgpack checkpoint:
  the state_dict after the restore equals the bridged weights; a
  checkpoint of another graph is refused.
* The shapefix train split and its val equal ``parity_fixture --kind
  shapefix``'s, bit for bit (2 and 1 scans).
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
    GroupFreeDetector as JaxGroupFree
from backtoreality_tpu.train import common as jcommon
from backtoreality_tpu.train import groupfree as jgroupfree
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.losses import groupfree as tlosses
from backtoreality_tpu_torch.train import common as tcommon
from backtoreality_tpu_torch.train import (evaluate, gf_fsb, gf_wsb,
                                           groupfree, votenet_fsb)
from test_torch_groupfree import (FFN, LAYERS, LOSS_KW, NUM_PROPOSAL,
                                  gf_batch, jax_config, jax_init,
                                  model_kwargs, port_model, v64)

BN_MOMENTUM = 0.1


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
    d = tmp_path_factory.mktemp("torch_gf_train_scans")
    write_synthetic_scans(d, jax_config(), num_scans=4, num_objects=4,
                          points_per_object=400, floor_points=800, seed=6)
    return d


@pytest.fixture(scope="module")
def two_scans(tmp_path_factory):
    """Two scans: one step an epoch at batch 2, for the entry points."""
    d = tmp_path_factory.mktemp("torch_gf_two_scans")
    write_synthetic_scans(d, jax_config(), num_scans=2, num_objects=4,
                          points_per_object=400, floor_points=800, seed=7)
    return d


@pytest.fixture(scope="module")
def setup(scans):
    cfg = jax_config()
    batch = gf_batch(scans, cfg, center_jitter=0.1)
    return dict(cfg=cfg, batch=batch, variables=jax_init(cfg, batch))


def _capture_grads():
    """An optax transformation that keeps the gradients as its state and
    leaves the parameters unchanged."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    return optax.GradientTransformation(
        zeros, lambda g, state, params=None: (zeros(g), g))


def test_train_step_gradients_match_jax_f64(setup):
    cfg, batch = setup["cfg"], setup["batch"]
    variables = v64(setup["variables"])
    jax.config.update("jax_enable_x64", True)
    try:
        msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
        model = JaxGroupFree(mean_size_arr=msa, dtype=jnp.float64,
                             head_dtype=jnp.float64, dropout_rate=0.0,
                             **model_kwargs(cfg))
        optimizer = _capture_grads()
        state = jcommon.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=optimizer.init(variables["params"]))
        step_fn = jgroupfree.make_train_step(model, optimizer,
                                             jlosses.get_loss, cfg, LOSS_KW)
        state, aux_j = jax.device_get(step_fn(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), np.float64(BN_MOMENTUM)))
    finally:
        jax.config.update("jax_enable_x64", False)

    port = port_model(cfg, setup["variables"], dropout_rate=0.0)
    opt = torch.optim.SGD(port.parameters(), lr=0.0)
    step = groupfree.make_train_step(port, opt, tlosses.get_loss, cfg,
                                     LOSS_KW)
    aux = step(tcommon.to_device(batch, "cpu"), BN_MOMENTUM)
    assert set(aux) == set(aux_j)
    for key, want in aux_j.items():
        np.testing.assert_allclose(aux[key].item(), float(want), rtol=1e-7,
                                   err_msg=key)

    want_grads = state_dict_from_jax({"params": state.opt_state})
    params = dict(port.named_parameters())
    assert set(want_grads) == set(params)
    for name, want in want_grads.items():
        grad = params[name].grad
        got = np.zeros(want.shape) if grad is None else grad.numpy()
        err = np.linalg.norm(got - want.numpy())
        assert err <= 1e-6 * np.linalg.norm(want.numpy()) + 1e-12, name
    want_stats = state_dict_from_jax({"batch_stats": state.batch_stats})
    buffers = dict(port.named_buffers())
    assert set(want_stats) == set(buffers)
    for name, want in want_stats.items():
        # the query position embeddings read the float32 heads' boxes
        atol = 1e-8 if name.startswith("decoder_self_posembeds") else 1e-9
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(),
                                   rtol=0, atol=atol, err_msg=name)


def _flags(**kw):
    return groupfree.add_flags(argparse.ArgumentParser()).parse_args(
        [f"--{k}={v}" for k, v in kw.items()])


class _Named(torch.nn.Module):
    """Linear layers under the detector's top-level names, the lists as
    ``nn.ModuleList``s: what the optimizer groups by."""

    def __init__(self):
        super().__init__()
        self.backbone_net = torch.nn.Linear(5, 4)
        self.decoder_key_proj = torch.nn.Linear(4, 4)
        self.decoder = torch.nn.ModuleList([torch.nn.Linear(4, 3)] * 1)
        self.decoder_self_posembeds = torch.nn.ModuleList(
            [torch.nn.Linear(3, 4)])
        self.prediction_heads = torch.nn.ModuleList([torch.nn.Linear(4, 2)])


def test_gf_optimizer_matches_optax_f64():
    flags = _flags(**{"warmup-epoch": 1, "max_epoch": 4})
    spe = 2  # the warmup spans the first 2 of the 4 steps
    port = _Named().double()
    rng = np.random.default_rng(3)
    shapes = {name: tuple(p.shape) for name, p in port.named_parameters()}

    def tree(arrays):  # port names -> the JAX package's params tree
        out = {}
        for name, a in arrays.items():
            *mods, leaf = name.split(".")
            if mods[-1].isdigit():
                mods = [f"{mods[0]}_{mods[1]}"]
            leaf = {"weight": "kernel"}.get(leaf, leaf)
            out.setdefault(mods[0], {})[leaf] = (a.T if leaf == "kernel"
                                                 else a)
        return out

    start = {n: rng.normal(size=s) for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s) for n, s in shapes.items()}
             for _ in range(4)]
    grads[1] = {n: g * 1e-3 for n, g in grads[1].items()}  # under the clip
    jax.config.update("jax_enable_x64", True)
    try:
        jopt = jcommon.make_gf_optimizer(
            jcommon.make_gf_schedule(flags.learning_rate, flags, spe),
            jcommon.make_gf_schedule(flags.decoder_learning_rate, flags,
                                     spe), flags.weight_decay,
            flags.clip_norm)
        params = jax.tree_util.tree_map(jnp.asarray, tree(start))
        state = jopt.init(params)
        trajectory = []
        for g in grads:
            updates, state = jopt.update(
                jax.tree_util.tree_map(jnp.asarray, tree(g)), state, params)
            params = optax.apply_updates(params, updates)
            trajectory.append(state_dict_from_jax(
                {"params": jax.device_get(params)}))
    finally:
        jax.config.update("jax_enable_x64", False)

    port.load_state_dict(state_dict_from_jax({"params": tree(start)}))
    topt = tcommon.make_gf_optimizer(
        port, tcommon.make_gf_schedule(flags.learning_rate, flags, spe),
        tcommon.make_gf_schedule(flags.decoder_learning_rate, flags, spe),
        flags.weight_decay, flags.clip_norm)
    assert [g["name"] for g in topt.param_groups] == ["main", "decoder"]
    assert [len(g["params"]) for g in topt.param_groups] == [4, 6]
    named = dict(port.named_parameters())
    for g, want in zip(grads, trajectory):
        for name, p in named.items():
            p.grad = torch.from_numpy(g[name].copy())
        topt.step()
        for name, w in want.items():
            # the distance travelled; optax's schedules round the learning
            # rate to float32 (a few 1e-10 of it during the warmup)
            np.testing.assert_allclose(
                named[name].detach().numpy() - start[name],
                w.numpy() - start[name], rtol=2e-5, atol=2e-9,
                err_msg=name)
    assert [g["count"] for g in topt.param_groups] == [4, 4]


@pytest.mark.parametrize("scheduler,warmup", [("step", -1), ("step", 2),
                                              ("cosine", -1),
                                              ("cosine", 2)])
def test_gf_schedules_match_jax(scheduler, warmup):
    flags = _flags(**{"lr-scheduler": scheduler, "warmup-epoch": warmup,
                      "max_epoch": 12, "lr_decay_epochs": 6,
                      "learning_rate": 0.004})
    spe = 3
    jsched = jcommon.make_gf_schedule(0.004, flags, spe)
    tsched = tcommon.make_gf_schedule(0.004, flags, spe)
    jax_lr = np.asarray(jax.vmap(jsched)(jnp.arange(40)))
    # optax's are float32: 1e-6 of a rate, a few 1e-10 where the warmup
    # cancels
    np.testing.assert_allclose([tsched(c) for c in range(40)], jax_lr,
                               rtol=1e-6, atol=1e-9)
    # the rate `main` logs: the one the optimizer applied at each step
    port = _Named()
    opt = tcommon.make_gf_optimizer(port, tsched, tsched)
    applied = []
    for _ in range(40):
        for p in port.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        applied.append(opt.param_groups[0]["lr"])
    np.testing.assert_allclose(applied, jax_lr, rtol=1e-6, atol=1e-9)


# the small detector's flags
SMALL = ["--num_point", "2048", "--batch_size", "2", "--num_target",
         str(NUM_PROPOSAL), "--num_decoder_layers", str(LAYERS),
         "--dim_feedforward", str(FFN), "--use_height"]


def _gf_args(scans, log_dir, max_epoch):
    return ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--log_dir", str(log_dir),
            "--max_epoch", str(max_epoch), "--val_freq", "2", *SMALL]


def test_gf_fsb_trains_checkpoints_and_resumes(two_scans, tmp_path,
                                               capsys):
    scans = two_scans
    log = tmp_path / "log"
    _, opt = gf_fsb.main(_gf_args(scans, log, 2) + ["--device", "cpu"])
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train_rows] == [0, 1]
    assert [r["lr"] for r in train_rows] == [0.004, 0.004]
    assert all(math.isfinite(r["loss"]) for r in train_rows)
    assert "last_box_loss" in train_rows[0]
    evals = [r for r in rows if r.get("kind") == "eval"]
    assert len(evals) == 1 and all(math.isfinite(evals[0][k]) for k in
                                   ("mAP", "mAP@0.25", "mAP@0.5"))
    ckpt = tcommon.load_checkpoint(log / "ckpt_epoch_last.tar")
    assert ckpt["epoch"] == 1
    assert (log / "ckpt_epoch_1.tar").exists()
    assert [g["count"] for g in ckpt["optimizer"]["param_groups"]] == [2, 2]

    results = evaluate.main([
        "--model", "groupfree", "--checkpoint_path",
        str(log / "ckpt_epoch_last.tar"), "--data_root", str(scans),
        "--split", "all", *SMALL, "--device", "cpu"])
    assert set(results) == {("last_", 0.25), ("last_", 0.5)}
    assert all(math.isfinite(m["mAP"]) for m in results.values())

    capsys.readouterr()
    _, opt = gf_fsb.main(_gf_args(scans, log, 3) + ["--device", "cpu",
                                                    "--resume"])
    out = capsys.readouterr().out
    assert "resumed" in out and "(epoch 1)" in out
    assert "epoch 002" in out and "epoch 000" not in out
    assert [g["count"] for g in opt.param_groups] == [3, 3]


def test_gf_wsb_trains(two_scans, tmp_path):
    log = tmp_path / "wsb"
    gf_wsb.main(_gf_args(two_scans, log, 1) + ["--device", "cpu",
                                           "--val_freq", "1"])
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    assert math.isfinite(rows[0]["loss"]) and "last_center_loss" in rows[0]
    assert math.isfinite(rows[1]["mAP"])


@pytest.mark.parametrize("flag", [
    "--num_devices=1", "--multihost", "--profile_dir", "--guard_every_steps=0",
    "--ram_cache_gb=0"])
def test_gf_takes_ops_flags(two_scans, tmp_path, monkeypatch, flag):
    """Each operations flag of the JAX trainer is taken: one process (a
    group of one with --multihost) trains an epoch."""
    if flag == "--multihost":
        monkeypatch.setenv("BTR_NUM_PROCESSES", "1")
    extra = [flag, str(tmp_path / "trace")] if flag == "--profile_dir" \
        else [flag]
    model, _ = gf_fsb.main(_gf_args(two_scans, tmp_path / "log", 1)
                           + ["--device", "cpu", *extra])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert tcommon.load_checkpoint(tmp_path / "log" / "ckpt_epoch_last.tar")[
        "epoch"] == 0


def test_gf_fsb_takes_query_mode_exact(two_scans, tmp_path):
    """One epoch and an evaluation with the reference's first-k query in
    every set-abstraction layer."""
    log = tmp_path / "log"
    model, _ = gf_fsb.main(_gf_args(two_scans, log, 1)
                           + ["--device", "cpu", "--val_freq", "1",
                              "--query_mode", "exact"])
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    assert math.isfinite(rows[0]["loss"]) and math.isfinite(rows[1]["mAP"])
    backbone = model.backbone_net
    assert {getattr(backbone, f"sa{i}").query_mode
            for i in range(1, 5)} == {"exact"}


@pytest.mark.parametrize("extra", [
    ["--bf16", "--f32_tail=1", "--bn_recal_batches=1"],
    ["--bn_recal_batches=2"]])
def test_gf_fsb_takes_the_precision_and_recal_flags(two_scans, tmp_path,
                                                    extra):
    """One epoch and an evaluation, BN recalibrated before it."""
    log = tmp_path / "log"
    model, _ = gf_fsb.main(_gf_args(two_scans, log, 1)
                           + ["--device", "cpu", "--val_freq", "1", *extra])
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    assert math.isfinite(rows[0]["loss"]) and math.isfinite(rows[1]["mAP"])
    assert model.backbone_net.sa1.mlp.dense0.compute_dtype == (
        torch.bfloat16 if "--bf16" in extra else None)
    assert all(b.dtype == torch.float32 for b in model.buffers())


@pytest.mark.parametrize("recipe", groupfree.RECIPES)
def test_gf_recipes_need_cuda(scans, tmp_path, monkeypatch, recipe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _gf_args(scans, tmp_path / "log", 1)
    if recipe in ("br", "br_center_refine"):
        args += ["--source_data_root", str(scans)]
    with pytest.raises(RuntimeError, match="--device cpu"):
        groupfree.main(recipe, args)


def _jax_gf_checkpoint(setup, path):
    """A checkpoint of the small detector written by the JAX package."""
    flags = _flags()
    variables = setup["variables"]
    optimizer = jcommon.make_gf_optimizer(flags.learning_rate,
                                          flags.decoder_learning_rate)
    state = jcommon.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=optimizer.init(variables["params"]))
    jcommon.save_checkpoint(path, state, 7)
    return path


def _blob_scans(root, cfg, cls):
    """Four scans of four objects each and no floor, every object of
    class `cls` at its mean size and its points drawn in to 5% of its box
    around the centre: a query on an object's points is near its
    centre."""
    write_synthetic_scans(root, cfg, num_scans=4, num_objects=4,
                          points_per_object=600, floor_points=0, seed=6)
    raw = int(cfg.raw_ids[cls])
    for vert_file in sorted(root.glob("*_vert.npy")):
        stem = str(vert_file)[:-len("_vert.npy")]
        vert, ins = np.load(vert_file), np.load(stem + "_ins_label.npy")
        sem, bbox = (np.load(stem + "_sem_label.npy"),
                     np.load(stem + "_bbox.npy"))
        for i, box in enumerate(bbox):
            on = ins == i + 1
            vert[on, :3] = box[:3] + 0.05 * (vert[on, :3] - box[:3])
            sem[on] = raw
            box[3:6], box[-1] = cfg.mean_size_arr[cls], raw
        np.save(vert_file, vert)
        np.save(stem + "_sem_label.npy", sem)
        np.save(stem + "_bbox.npy", bbox)
    return root


def lamp_heads(params, lamp):
    """In place: every head at a tenth of its residuals, the last one
    made to call every query a `lamp` of the mean size."""
    for name in ("proposal_head",
                 *(f"prediction_heads_{i}" for i in range(LAYERS))):
        for head in ("center_residual", "size_residual",
                     "heading_residual"):
            for leaf in params[name][head].values():
                leaf *= 0.1
    last = params[f"prediction_heads_{LAYERS - 1}"]
    last["sem_cls"]["bias"][lamp] += 8.0
    last["size_class"]["bias"][lamp] += 8.0


def test_evaluate_groupfree_scores_a_jax_checkpoint(setup, tmp_path,
                                                     capsys):
    """The JAX init with its last head set to call every query a lamp of
    the mean size, every head at a tenth of its residuals, scored on
    `_blob_scans` with queries by FPS: each object's first box is right
    and its duplicates are false positives unless NMS removes them, so
    the JAX mAP (1 here) falls with a wrong head, decode or NMS."""
    from backtoreality_tpu.train import evaluate as jevaluate

    cfg = setup["cfg"]
    lamp = cfg.type2class["lamp"]
    scans = _blob_scans(tmp_path / "scans", cfg, lamp)
    variables = jax.tree_util.tree_map(np.array, setup["variables"])
    lamp_heads(variables["params"], lamp)
    ckpt = _jax_gf_checkpoint(dict(variables=variables),
                              tmp_path / "gf.msgpack")
    args = ["--model", "groupfree", "--checkpoint_path", str(ckpt),
            "--data_root", str(scans), "--split", "all", "--eval_seeds",
            "2", *SMALL, "--sampling", "fps"]
    capsys.readouterr()
    jevaluate.main(args + ["--num_devices", "1"])
    out = capsys.readouterr().out
    want = [[float(v) for v in m.group(1).split()] for m in re.finditer(
        r"^  mAP: .*\(seeds: ([0-9. ]+)\)$", out, re.M)]
    results = evaluate.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded checkpoint" in out and "from epoch 7" in out
    got = [[r["mAP"] for r in results[("last_", t)]["seeds"]]
           for t in (0.25, 0.5)]
    assert len(want) == 2 and len(want[0]) == 2
    assert min(want[0]) > 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=0.005)


def test_warm_start_from_a_jax_checkpoint(setup, scans, tmp_path):
    """FSB training from the JAX package's weights: after the restore the
    port's state_dict equals the bridged checkpoint; a checkpoint of
    another graph is refused rather than trained from fresh leaves."""
    from backtoreality_tpu.models.votenet import VoteNet as JaxVoteNet

    cfg = setup["cfg"]
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    jmodel = JaxVoteNet(mean_size_arr=msa, num_class=cfg.num_class,
                        num_heading_bin=cfg.num_heading_bin,
                        num_size_cluster=cfg.num_size_cluster,
                        input_feature_dim=1, num_proposal=16)
    pc = jnp.asarray(setup["batch"]["point_clouds"][:1], jnp.float32)
    variables = jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(jax.random.PRNGKey(4),
                                                     pc))
    state = jcommon.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=())
    vn_ckpt = tmp_path / "votenet.msgpack"
    jcommon.save_checkpoint(vn_ckpt, state, 3)
    base = ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--max_epoch", "0", "--num_point", "2048",
            "--batch_size", "2", "--device", "cpu"]
    model, _ = votenet_fsb.main(base + [
        "--num_target", "16", "--log_dir", str(tmp_path / "vn"),
        "--checkpoint_path", str(vn_ckpt)])
    want = state_dict_from_jax(variables)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    with pytest.raises(SystemExit, match="does not cover the VoteNet"):
        votenet_fsb.main(base + ["--num_target", "16", "--no_height",
                                 "--log_dir", str(tmp_path / "vn2"),
                                 "--checkpoint_path", str(vn_ckpt)])

    gf_ckpt = _jax_gf_checkpoint(setup, tmp_path / "gf.msgpack")
    gf_base = _gf_args(scans, tmp_path / "gf", 0) + ["--device", "cpu"]
    model, _ = gf_fsb.main(gf_base + ["--checkpoint_path", str(gf_ckpt)])
    want = state_dict_from_jax(setup["variables"])
    for name, w in model.state_dict().items():
        assert torch.equal(w, want[name]), name
    with pytest.raises(SystemExit, match="does not cover the GroupFree3D"):
        gf_fsb.main(gf_base + ["--checkpoint_path", str(vn_ckpt)])


def test_shapefix_train_equals_the_jax_fixture(tmp_path):
    from backtoreality_tpu.tools import parity_fixture
    from backtoreality_tpu_torch.datagen.shapefix import write_shapefix_train

    parity_fixture.main(["--kind", "shapefix", "--train_scans", "2",
                         "--val_scans", "1", "--out", str(tmp_path / "jax")])
    train, val = write_shapefix_train(tmp_path / "port", num_scans=2,
                                      val_scans=1)
    assert len(train) == 2 and len(val) == 1
    for part in ("train", "val"):
        files = sorted(p.name for p in (tmp_path / "jax" / part).iterdir())
        assert files == sorted(
            p.name for p in (tmp_path / "port" / part).iterdir())
        assert len(files) >= 3
        for name in files:
            assert ((tmp_path / "jax" / part / name).read_bytes()
                    == (tmp_path / "port" / part / name).read_bytes()), name
