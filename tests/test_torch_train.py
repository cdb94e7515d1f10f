"""The port's FSB training slice against the JAX package's, on the CPU.

* Gradients at init, float64 (JAX with x64 on; f32 is ill-conditioned in
  the FP layers, see tests/test_torch_votenet.py): one JAX
  `make_train_step` and the port's loss and backward from the same
  bridged weights on one labelled batch (B=2, N=2048, 64 proposals,
  vote_fps, stratified query). The loss and aux scalars agree to rtol
  1e-9, every parameter gradient to 1e-7 of its leaf's norm, and the BN
  running statistics after the step to atol 1e-9.
* Trajectory: 3 SGD steps (lr 1e-4, f64, seed_fps) from the same init;
  the losses track to rtol 1e-5. SGD, not Adam, as in
  tests/test_train_dynamics_parity.py: Adam's first update is
  lr * sign(g), which turns rounding noise in near-zero gradients into
  full-size steps.
* Adam and AdamW (and the global-norm clip) against optax through the
  JAX package's `make_optimizer`, fed the same gradients for 5 steps
  with a learning-rate change after step 2: parameters to atol 1e-6 in
  float32.
* The schedules equal the JAX ones at every epoch 0-200.
* The entry point `votenet_fsb.main` trains two epochs on a 4-scan
  synthetic fixture with ``--device cpu``, writes a checkpoint that
  `evaluate.main` loads, resumes from it at the next epoch with the
  optimizer state restored, and raises without a card when no device is
  given; it takes each operations flag of the JAX trainer, and refuses
  ``--num_devices`` above the visible cards.
"""

import json
import math

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
from backtoreality_tpu.models.votenet import VoteNet as JaxVoteNet
from backtoreality_tpu.nn import norm as jnorm
from backtoreality_tpu.train import common as jcommon
from backtoreality_tpu.train.votenet import make_train_step as jax_train_step
from backtoreality_tpu_torch.bridge import state_dict_from_jax
from backtoreality_tpu_torch.losses import votenet as tlosses
from backtoreality_tpu_torch.models.votenet import VoteNet
from backtoreality_tpu_torch.nn import bn_momentum_schedule, set_bn_momentum
from backtoreality_tpu_torch.train import common as tcommon
from backtoreality_tpu_torch.train import evaluate, votenet_fsb
from backtoreality_tpu_torch.train.votenet import make_train_step, to_device

B, N, NUM_PROPOSAL = 2, 2048, 64
BN_MOMENTUM = 0.1  # not exact in f32: exercises the momentum rounding


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Labelled batch (height feature) and the JAX init, in f64."""
    d = tmp_path_factory.mktemp("torch_train_scans")
    cfg = jax_config()
    write_synthetic_scans(d, cfg, num_scans=B, num_objects=4,
                          points_per_object=400, floor_points=800, seed=2)
    ds = DetectionDataset(cfg, d, split="all", num_points=N,
                          use_height=True)
    items = [ds.get(i) for i in range(B)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    batch64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
               for k, v in batch.items()}
    kw = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
              num_size_cluster=cfg.num_size_cluster, input_feature_dim=1,
              num_proposal=NUM_PROPOSAL)
    msa = tuple(map(tuple, cfg.mean_size_arr.tolist()))
    model = JaxVoteNet(mean_size_arr=msa, **kw)
    variables = jax.device_get(jax.jit(
        lambda k, x: model.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(batch["point_clouds"][:1])))
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 variables)
    return dict(cfg=cfg, batch64=batch64, kw=kw, msa=msa, v64=v64)


def _jax_steps(setup, sampling, optimizer, steps):
    """Run the JAX train step `steps` times in x64; returns the final
    state and the aux scalars of every step."""
    jax.config.update("jax_enable_x64", True)
    try:
        model = JaxVoteNet(mean_size_arr=setup["msa"], sampling=sampling,
                           dtype=jnp.float64, head_dtype=jnp.float64,
                           **setup["kw"])
        params = setup["v64"]["params"]
        state = jcommon.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=setup["v64"]["batch_stats"],
            opt_state=optimizer.init(params))
        step_fn = jax_train_step(model, optimizer, jlosses.get_loss,
                                 setup["cfg"])
        batch = {k: jnp.asarray(v) for k, v in setup["batch64"].items()}
        auxes = []
        for _ in range(steps):
            state, aux = step_fn(state, batch, jax.random.PRNGKey(0),
                                 np.float64(BN_MOMENTUM))
            auxes.append(jax.device_get(aux))
        return jax.device_get(state), auxes
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_model(setup, sampling):
    cfg = setup["cfg"]
    model = VoteNet(mean_size_arr=cfg.mean_size_arr, sampling=sampling,
                    **setup["kw"])
    model.load_state_dict(state_dict_from_jax(setup["v64"]))  # strict
    return model.double()


def _capture_grads():
    """An optax transformation that keeps the gradients as its state and
    leaves the parameters unchanged."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    return optax.GradientTransformation(
        zeros, lambda g, state, params=None: (zeros(g), g))


def test_gradients_at_init_match_jax_f64(setup):
    state, (aux_j,) = _jax_steps(setup, "vote_fps", _capture_grads(), 1)
    model = _port_model(setup, "vote_fps")
    model.train()
    set_bn_momentum(model, BN_MOMENTUM)
    batch = to_device(setup["batch64"], "cpu")
    loss, aux = tlosses.get_loss({**batch, **model(batch["point_clouds"])},
                                 setup["cfg"])
    loss.backward()

    assert set(aux_j) <= set(aux)
    for key, want in aux_j.items():
        np.testing.assert_allclose(aux[key].item(), float(want), rtol=1e-9,
                                   err_msg=key)
    want_grads = state_dict_from_jax({"params": state.opt_state})
    params = dict(model.named_parameters())
    assert set(want_grads) == set(params)
    for name, want in want_grads.items():
        got = params[name].grad.numpy()
        err = np.linalg.norm(got - want.numpy())
        assert err <= 1e-7 * np.linalg.norm(want.numpy()), name
    want_stats = state_dict_from_jax({"batch_stats": state.batch_stats})
    buffers = dict(model.named_buffers())
    for name, want in want_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(),
                                   rtol=0, atol=1e-9, err_msg=name)


def test_sgd_trajectory_tracks_jax_f64(setup):
    lr, steps = 1e-4, 3
    _, auxes = _jax_steps(setup, "seed_fps", optax.sgd(lr), steps)
    jax_losses = [float(a["loss"]) for a in auxes]
    model = _port_model(setup, "seed_fps")
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=lr),
                           tlosses.get_loss, setup["cfg"])
    batch = to_device(setup["batch64"], "cpu")
    losses = [step(batch, BN_MOMENTUM)["loss"].item() for _ in range(steps)]
    assert abs(losses[0] - losses[-1]) > 1e-4  # the trajectory moves
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)


@pytest.mark.parametrize("kind,weight_decay,grad_clip",
                         [("adam", 0.0, None), ("adamw", 0.01, None),
                          ("adam", 0.0, 0.5)])
def test_optimizer_matches_optax(kind, weight_decay, grad_clip):
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (7,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    lrs = [1e-2, 1e-2, 3e-3, 3e-3, 3e-3]  # changed after step 2

    jopt = jcommon.make_optimizer(kind, weight_decay, grad_clip, lr0=lrs[0])
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = jcommon.TrainState(step=0, params=params, batch_stats={},
                               opt_state=jopt.init(params))
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    topt = tcommon.make_optimizer(tparams.values(), kind, weight_decay,
                                  grad_clip, lr0=lrs[0])
    for g, lr in zip(grads, lrs):
        state = jcommon.set_learning_rate(state, lr)
        updates, opt_state = jopt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, state.opt_state,
            state.params)
        state = state.replace(params=optax.apply_updates(state.params,
                                                         updates),
                              opt_state=opt_state)
        tcommon.set_learning_rate(topt, lr)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(state.params[k]), rtol=0,
                                       atol=1e-6, err_msg=k)


def test_schedules_match_jax():
    lr_j = jcommon.step_lr(1e-3, [80, 120, 160], [0.1, 0.1, 0.1])
    lr_t = tcommon.step_lr(1e-3, [80, 120, 160], [0.1, 0.1, 0.1])
    bn_j = jcommon.bn_momentum_fn(step=20, rate=0.5)
    bn_t = tcommon.bn_momentum_fn(step=20, rate=0.5)
    for epoch in range(201):
        assert lr_t(epoch) == lr_j(epoch)
        assert bn_t(epoch) == bn_j(epoch)
        assert (bn_momentum_schedule(epoch)
                == jnorm.bn_momentum_schedule(epoch))


def _fsb_args(scans, log_dir, max_epoch):
    return ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--log_dir", str(log_dir),
            "--max_epoch", str(max_epoch), "--eval_freq", "2",
            "--num_point", "2048", "--batch_size", "2", "--num_target",
            "64"]


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fsb_scans")
    write_synthetic_scans(d, jax_config(), num_scans=4, num_objects=3,
                          points_per_object=300, floor_points=800, seed=0)
    return d


def test_votenet_fsb_trains_checkpoints_and_resumes(scans, tmp_path,
                                                    capsys):
    log = tmp_path / "log"
    _, opt = votenet_fsb.main(_fsb_args(scans, log, 2) + ["--device",
                                                          "cpu"])
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train_rows] == [0, 1]
    assert all(math.isfinite(r["loss"]) for r in train_rows)
    assert any(r.get("kind") == "eval" and math.isfinite(r["mAP"])
               for r in rows)
    ckpt = tcommon.load_checkpoint(log / "checkpoint.tar")
    assert ckpt["epoch"] == 1 and set(ckpt) == {"epoch", "model",
                                                "optimizer"}
    steps = ckpt["optimizer"]["state"][0]["step"].item()
    assert steps == 4  # 2 epochs of 2 batches

    results = evaluate.main([
        "--checkpoint_path", str(log / "checkpoint.tar"), "--data_root",
        str(scans), "--split", "all", "--num_point", "2048",
        "--num_target", "64", "--batch_size", "2", "--device", "cpu"])
    assert all(math.isfinite(m["mAP"]) for m in results.values())

    capsys.readouterr()
    _, opt = votenet_fsb.main(_fsb_args(scans, log, 3) + [
        "--device", "cpu", "--checkpoint_path",
        str(log / "checkpoint.tar"), "--resume"])
    out = capsys.readouterr().out
    assert "restored full state" in out and "(epoch 1)" in out
    assert "epoch 002" in out and "epoch 000" not in out
    assert opt.state_dict()["state"][0]["step"].item() == steps + 2
    assert tcommon.load_checkpoint(log / "checkpoint.tar")["epoch"] == 2


def test_votenet_fsb_needs_cuda_unless_cpu_asked(scans, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        votenet_fsb.main(_fsb_args(scans, tmp_path / "log", 1))


@pytest.mark.parametrize("flag", [
    "--num_devices=1", "--multihost", "--profile_dir", "--guard_every_steps=0",
    "--ram_cache_gb=0"])
def test_votenet_fsb_takes_ops_flags(scans, tmp_path, monkeypatch, flag):
    """Each operations flag of the JAX trainer is taken: one process (a
    group of one with --multihost, its address picked) trains an epoch."""
    if flag == "--multihost":
        monkeypatch.setenv("BTR_NUM_PROCESSES", "1")
    extra = [flag, str(tmp_path / "trace")] if flag == "--profile_dir" \
        else [flag]
    model, _ = votenet_fsb.main(_fsb_args(scans, tmp_path / "log", 1)
                                + ["--device", "cpu", *extra])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert tcommon.load_checkpoint(tmp_path / "log" / "checkpoint.tar")[
        "epoch"] == 0


def test_votenet_fsb_refuses_more_devices_than_visible(scans, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--num_devices 2"):
        votenet_fsb.main(_fsb_args(scans, tmp_path / "log", 1)
                         + ["--num_devices", "2"])


@pytest.mark.parametrize("flags", [
    ["--bf16"], ["--bf16", "--f32_tail=6", "--bn_recal_batches=1",
                 "--eval_freq=1"]])
def test_votenet_fsb_takes_bf16(scans, tmp_path, flags):
    """bfloat16 compute over float32 parameters and statistics; the
    second case also evaluates, after one recalibration batch. The
    checkpoint holds no dtype: a float32 model loads it unchanged."""
    log = tmp_path / "log"
    model, _ = votenet_fsb.main(_fsb_args(scans, log, 1)
                                + ["--device", "cpu", *flags])
    cfg = jax_config()
    plain = VoteNet(num_class=cfg.num_class,
                    num_heading_bin=cfg.num_heading_bin,
                    num_size_cluster=cfg.num_size_cluster,
                    mean_size_arr=cfg.mean_size_arr, input_feature_dim=1,
                    num_proposal=64)
    assert tcommon.restore_weights(plain, log / "checkpoint.tar",
                                   "VoteNet") == 0
    for k, v in plain.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    assert math.isfinite(rows[0]["loss"])
    assert len(rows) == (2 if "--eval_freq=1" in flags else 1)
    sa1 = model.backbone_net.sa1.mlp.dense0.compute_dtype
    assert sa1 == (None if "--f32_tail=6" in flags else torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
