"""The port's trainers on several processes, the preemption guard and
the observability hooks, on the CPU.

* The two-process contract of tests/test_multiprocess.py, held for the
  port: ``votenet_fsb --device cpu --multihost`` launched twice with the
  ``BTR_*`` variables (gloo) on a 4-scan fixture, batch 2 a process:
  the same epoch losses on both ranks, one checkpoint (rank 0's), the
  rank-1 log, an evaluation in both logs, and a resume that runs the
  next epoch on both ranks.
* ``--num_devices 2 --device cpu`` (two spawned ranks, each with one row
  of every batch of 2) against ``--num_devices 1``: 2 epochs at learning
  rate 0, so both runs hold the same weights and their losses and
  evaluation compare at one point. Float32: the rows' BN moments summed
  in another order move a step's loss by about 1e-5 relative (so does a
  permutation of the rows in one process), so the epoch losses are held
  to 1e-4, the mAP and AR to 1e-6. With a learning rate, Adam's first
  update (lr times the sign of each gradient) turns that noise in
  near-zero gradients into full steps, and the runs part; the float64
  steps of tests/test_torch_parallel.py hold the gradients.
* The guard (mirroring tests/test_preemption.py): SIGTERM writes the
  latest snapshot and exits with 143; the snapshot is the state at
  `update`, not the state an in-place ``optimizer.step()`` made later;
  nothing is written without a snapshot; a trainer with
  ``--guard_every_steps 1`` sent SIGTERM in its second epoch exits with
  143 having saved the first epoch's number, and ``--resume`` re-runs the
  second.
* ``common.spawn``: a failing rank fails the launch at once with its
  exit code, ranks past the time limit are killed (124), and what runs
  meanwhile is returned; ``--multihost``'s count of processes on a host
  (``LOCAL_WORLD_SIZE``, ``BTR_LOCAL_PROCESSES``, 1) and the backend rule.
* `StepTimer`; `ScalarHistory`, checkpoints and the config are written
  on rank 0 only; `profile` writes a Chrome trace of what ran within;
  ``--ram_cache_gb 0`` turns the datasets' RAM cache off.

Every process started here has a time limit, and is killed at it.
"""

import argparse
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from backtoreality_tpu_torch import parallel
from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
from backtoreality_tpu_torch.train import common, observability, votenet

import torch_parallel_ranks

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 300  # seconds for any process started here


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ops_scans")
    write_synthetic_scans(d, get_config("scannet_md40"), num_scans=4,
                          num_objects=3, points_per_object=300,
                          floor_points=800, seed=0)
    return d


def _args(scans, log_dir, *extra):
    return ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--num_point", "2048", "--num_target",
            "32", "--device", "cpu", "--log_dir", str(log_dir), *extra]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", **extra)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(procs):
    """Wait for every process within TIMEOUT (all are killed at it);
    returns their (exit code, output)."""
    deadline = time.monotonic() + TIMEOUT
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               0.0))
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _trainer(args, env, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "backtoreality_tpu_torch.train.votenet_fsb",
         *args], env=env, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _pair(args, cwd):
    port = parallel.free_port()
    outs = _run([_trainer(args, _env(
        BTR_COORDINATOR=f"127.0.0.1:{port}", BTR_NUM_PROCESSES="2",
        BTR_PROCESS_ID=str(r)), cwd) for r in range(2)])
    for rc, out in outs:
        assert rc == 0, out[-3000:]


def _epoch_losses(text):
    return {int(m.group(1)): float(m.group(2)) for m in
            re.finditer(r"epoch (\d+) .*?loss ([\d.]+)", text)}


def test_two_process_contract_and_resume(scans, tmp_path):
    log = tmp_path / "log"
    args = _args(scans, log, "--batch_size", "2", "--eval_freq", "2",
                 "--multihost")
    _pair(args + ["--max_epoch", "2"], tmp_path)
    log0 = (log / "log_train.txt").read_text()
    log1 = (log / "log_train.txt.rank1").read_text()
    l0, l1 = _epoch_losses(log0), _epoch_losses(log1)
    assert sorted(l0) == sorted(l1) == [0, 1]
    assert l0 == l1 and np.isfinite(list(l0.values())).all()
    assert [c.name for c in log.glob("*.tar")] == ["checkpoint.tar"]
    assert "eval mAP" in log0 and "eval mAP" in log1

    _pair(args + ["--max_epoch", "3", "--resume", "--checkpoint_path",
                  str(log / "checkpoint.tar")], tmp_path)
    l0 = _epoch_losses((log / "log_train.txt").read_text())
    l1 = _epoch_losses((log / "log_train.txt.rank1").read_text())
    assert 2 in l0 and l0[2] == l1[2]
    assert common.load_checkpoint(log / "checkpoint.tar")["epoch"] == 2


def test_num_devices_two_matches_one(scans, tmp_path):
    rows = {}
    for n in (1, 2):
        log = tmp_path / f"log{n}"
        (rc, out), = _run([_trainer(_args(
            scans, log, "--batch_size", "2", "--max_epoch", "2",
            "--eval_freq", "2", "--learning_rate", "0", "--num_devices",
            str(n)), _env(), tmp_path)])
        assert rc == 0, out[-3000:]
        rows[n] = [json.loads(line) for line in
                   (log / "metrics.jsonl").read_text().splitlines()]
    assert (tmp_path / "log2" / "log_train.txt.rank1").exists()
    one, two = rows[1], rows[2]
    assert [r["step"] for r in one] == [r["step"] for r in two] == [0, 1, 1]
    for a, b in zip(one[:2], two[:2]):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
    for key in ("mAP", "AR"):
        assert two[2][key] == pytest.approx(one[2][key], abs=1e-6)


def _model_and_adam():
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()  # the optimizer holds state
    return model, opt


def _sigterm(guard):
    try:
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
            # the handler runs in this thread, between two bytecodes
        return exc.value.code
    finally:
        guard.close()


def test_guard_saves_the_snapshot_on_sigterm(tmp_path):
    model, opt = _model_and_adam()
    path = tmp_path / "preempt.tar"
    guard = common.PreemptionGuard(path)
    guard.update(model, opt, epoch=12)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    assert _sigterm(guard) == 143
    ckpt = common.load_checkpoint(path)
    assert ckpt["epoch"] == 12
    for k, v in want.items():
        assert torch.equal(ckpt["model"][k], v)
    assert ckpt["optimizer"]["state"][0]["step"].item() == 1


def test_guard_snapshot_survives_an_in_place_step(tmp_path):
    """``optimizer.step()`` changes the parameters and the optimizer's
    moments in place after `update`: the snapshot keeps their values at
    `update`."""
    model, opt = _model_and_adam()
    path = tmp_path / "stepped.tar"
    guard = common.PreemptionGuard(path)
    guard.update(model, opt, epoch=3)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    moment = opt.state_dict()["state"][0]["exp_avg"].clone()
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    assert not torch.equal(model.weight, want["weight"])
    assert _sigterm(guard) == 143
    ckpt = common.load_checkpoint(path)
    assert ckpt["epoch"] == 3
    for k, v in want.items():
        assert torch.equal(ckpt["model"][k], v)
    assert torch.equal(ckpt["optimizer"]["state"][0]["exp_avg"], moment)
    assert ckpt["optimizer"]["state"][0]["step"].item() == 1


def test_guard_writes_nothing_without_a_snapshot(tmp_path):
    path = tmp_path / "nothing.tar"
    assert _sigterm(common.PreemptionGuard(path)) == 143
    assert not path.exists()


def test_trainer_sigterm_mid_epoch_resumes(tmp_path):
    """Batch 1 over 8 scans: 8 steps an epoch. SIGTERM comes once epoch 0's
    checkpoint is there, in epoch 1: the guard's newest snapshot (taken
    after a step of epoch 1 and saved as epoch 0, or if the signal beat
    that step, epoch 0's last) is written; the resume re-runs epoch 1."""
    root = tmp_path / "eight"
    write_synthetic_scans(root, get_config("scannet_md40"), num_scans=8,
                          num_objects=3, points_per_object=300,
                          floor_points=800, seed=1)
    log = tmp_path / "log"
    args = _args(root, log, "--batch_size", "1", "--max_epoch", "2",
                 "--eval_freq", "5", "--guard_every_steps", "1")
    proc = _trainer(args, _env(), tmp_path)
    try:
        deadline = time.monotonic() + TIMEOUT
        while not (log / "checkpoint.tar").exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(2.0)  # into epoch 1: its 8 steps take seconds here
        proc.send_signal(signal.SIGTERM)
    finally:
        (rc, out), = _run([proc])
    assert rc == 143, out[-3000:]
    assert "SIGTERM: saving checkpoint at epoch 0" in out
    ckpt = common.load_checkpoint(log / "checkpoint.tar")
    assert ckpt["epoch"] == 0
    assert ckpt["optimizer"]["state"][0]["step"].item() >= 8

    (rc, out), = _run([_trainer(args + ["--resume", "--checkpoint_path",
                                        str(log / "checkpoint.tar")],
                                _env(), tmp_path)])
    assert rc == 0, out[-3000:]
    assert "(epoch 0)" in out and "epoch 001" in out
    assert common.load_checkpoint(log / "checkpoint.tar")["epoch"] == 1


def test_spawn_fails_with_its_rank():
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as failed:
        common.spawn(torch_parallel_ranks.exit_on_rank_one, 2, 3,
                     timeout=TIMEOUT)
    assert failed.value.code == 3
    assert time.monotonic() - t0 < 45  # rank 0 was stopped, not awaited


def test_spawn_time_limit_and_meanwhile():
    assert common.spawn(torch_parallel_ranks.sleep, 2, 0, timeout=TIMEOUT,
                        meanwhile=lambda: 7) == 7
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as failed:
        common.spawn(torch_parallel_ranks.sleep, 2, 600, timeout=3)
    assert failed.value.code == 124
    assert time.monotonic() - t0 < 45


@pytest.mark.parametrize("env, count", [
    ({}, 1), ({"BTR_LOCAL_PROCESSES": "2"}, 2),
    ({"LOCAL_WORLD_SIZE": "4", "BTR_LOCAL_PROCESSES": "2"}, 4)])
def test_local_processes(monkeypatch, env, count):
    for name in ("LOCAL_WORLD_SIZE", "BTR_LOCAL_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert common.local_processes() == count


def test_backend_rule(monkeypatch):
    cuda = torch.device("cuda", 0)
    assert parallel.backend(torch.device("cpu"), 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.backend(cuda, 1) == parallel.backend(cuda, 2) == "nccl"
    assert parallel.backend(cuda, 3) == "gloo"  # two ranks share a card


def test_step_timer():
    t = observability.StepTimer()
    t.tick(8)
    t.tick(8)
    assert (t.steps, t.scenes) == (2, 16)
    assert t.scenes_per_sec > 0


def test_scalar_history_writes_on_rank_zero_only(tmp_path, monkeypatch):
    h = observability.ScalarHistory(tmp_path / "r0")
    h.append(0, {"loss": 1.5, "arr": np.zeros(3)}, lr=0.1)
    rows = [json.loads(line) for line in
            (tmp_path / "r0" / "metrics.jsonl").read_text().splitlines()]
    assert rows == [{"step": 0, "lr": 0.1, "loss": 1.5}]
    monkeypatch.setattr(parallel, "rank", lambda: 1)
    h = observability.ScalarHistory(tmp_path / "r1")
    h.append(0, {"loss": 1.5})
    assert not (tmp_path / "r1").exists()


def test_profile_writes_a_trace(tmp_path):
    window = observability.TraceWindow(tmp_path / "trace", first=2, last=3)
    x = torch.ones(64, 64)
    for step in range(1, 5):
        window.before(step)
        x = torch.mm(x, x) / 64
        window.after(step)
    window.close()
    trace = json.loads((tmp_path / "trace" / "trace_rank0.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert sum(name == "aten::mm" for name in names) == 2  # steps 2 and 3
    with observability.profile(None):  # no directory: no trace
        pass


def test_ram_cache_flag(tmp_path, scans):
    parser = votenet.add_common_flags(argparse.ArgumentParser())
    cfg = get_config("scannet_md40")
    for argv, cached in (([], True), (["--ram_cache_gb", "0"], False)):
        flags = parser.parse_args(argv)
        ds = votenet._dataset(flags, cfg, scans, "all", augment=False)
        assert (ds._cache is not None) == cached
    assert common.cache_kw(parser.parse_args([])) == dict(
        ram_cache=True, ram_cache_bytes=8 * 2**30)


def test_rank_one_writes_no_checkpoint_or_config(tmp_path, monkeypatch):
    """Every rank holds the same state: only rank 0 writes it."""
    model, opt = _model_and_adam()
    monkeypatch.setattr(parallel, "rank", lambda: 1)
    common.save_checkpoint(tmp_path / "ckpt.tar", model, opt, 0)
    common.dump_config(tmp_path / "log", {"a": 1})
    assert not (tmp_path / "ckpt.tar").exists()
    assert not (tmp_path / "log").exists()
    monkeypatch.setattr(parallel, "rank", lambda: 0)
    common.save_checkpoint(tmp_path / "ckpt.tar", model, opt, 0)
    assert common.load_checkpoint(tmp_path / "ckpt.tar")["epoch"] == 0
