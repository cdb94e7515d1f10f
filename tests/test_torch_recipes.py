"""The port's WSB, BR and BR+CenterRefine entry points on the CPU.

On a 4-scan real fixture and a 2-scan virtual one (``scene_aug`` names
under ``obj_aug``, so the source loader is the shorter and cycles), at
B=2, N=2048, 64 proposals: `votenet_{wsb,br,br_center_refine}.main
--device cpu` train two epochs, evaluate once and write their
checkpoints; CenterRefine grafts BR's checkpoint through the partial
restore; `evaluate.main --kind da_jitter --eval_seeds 2` scores
CenterRefine's checkpoint and returns every seed's metrics. Without a
card and ``--device cpu`` each entry point raises, and so does
``--multihost`` where the environment describes no process group.
`evaluate` refuses a checkpoint trained
with another graph than its ``--kind`` instead of scoring fresh weights.
"""

import argparse
import json
import math
import re

import numpy as np
import pytest
import torch

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
from backtoreality_tpu_torch.train import common as tcommon
from backtoreality_tpu_torch.train import (evaluate, votenet_br,
                                           votenet_br_center_refine,
                                           votenet_wsb)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once on a few cores, and more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    cfg = get_config("scannet_md40")
    real = tmp_path_factory.mktemp("torch_recipe_real")
    virtual = tmp_path_factory.mktemp("torch_recipe") / "obj_aug"
    write_synthetic_scans(real, cfg, num_scans=4, num_objects=3,
                          points_per_object=300, floor_points=800, seed=0)
    write_synthetic_scans(virtual, cfg, num_scans=2, num_objects=3,
                          points_per_object=300, floor_points=800, seed=1,
                          prefix="scene_aug")
    return real, virtual


def _recipe_args(fixtures, log_dir, recipe):
    real, virtual = fixtures
    args = ["--data_root", str(real), "--train_split", "all",
            "--val_split", "all", "--log_dir", str(log_dir),
            "--max_epoch", "2", "--eval_freq", "2", "--num_point", "2048",
            "--batch_size", "2", "--num_target", "64"]
    if recipe != "wsb":
        args += ["--source_data_root", str(virtual)]
    return args


def _epochs(log_dir):
    rows = [json.loads(line) for line in
            (log_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train] == [0, 1]
    assert all(math.isfinite(r["loss"]) for r in train)
    assert any(r.get("kind") == "eval" and math.isfinite(r["mAP"])
               for r in rows)


def test_recipes_train_graft_and_score(fixtures, tmp_path, capsys):
    logs = {r: tmp_path / r for r in ("wsb", "br", "br_center_refine")}
    votenet_wsb.main(_recipe_args(fixtures, logs["wsb"], "wsb")
                     + ["--device", "cpu"])
    _epochs(logs["wsb"])
    assert tcommon.load_checkpoint(logs["wsb"] / "checkpoint.tar")[
        "epoch"] == 1

    _, opt = votenet_br.main(_recipe_args(fixtures, logs["br"], "br")
                             + ["--device", "cpu"])
    _epochs(logs["br"])
    br_ckpt = logs["br"] / "train_BR.tar"
    assert tcommon.load_checkpoint(br_ckpt)["epoch"] == 1
    # 2 epochs of min(1, 2) pair-batches: the source's one batch cycles
    assert opt.state_dict()["state"][0]["step"].item() == 2
    assert (logs["br"] / "Eval_mAP.txt").read_text().startswith("1\t")

    capsys.readouterr()
    votenet_br_center_refine.main(
        _recipe_args(fixtures, logs["br_center_refine"], "br_center_refine")
        + ["--device", "cpu", "--checkpoint_path", str(br_ckpt)])
    out = capsys.readouterr().out
    restores = re.findall(r"partial restore: copied (\d+) leaves, kept"
                          r" (\d+) fresh", out)
    assert len(restores) == 2 and all(int(c) > 0 and int(k) > 0
                                      for c, k in restores)
    assert "grafted checkpoint" in out
    _epochs(logs["br_center_refine"])
    cr_ckpt = logs["br_center_refine"] / "train_BR_CenterRefine.tar"
    assert tcommon.load_checkpoint(cr_ckpt)["epoch"] == 1

    capsys.readouterr()
    results = evaluate.main([
        "--kind", "da_jitter", "--eval_seeds", "2", "--checkpoint_path",
        str(cr_ckpt), "--data_root", str(fixtures[0]), "--split", "all",
        "--num_point", "2048", "--num_target", "64", "--batch_size", "2",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(re.findall(r"partial restore: copied \d+ leaves, kept 0"
                          r" fresh", out)) == 2
    for metrics in results.values():
        assert len(metrics["seeds"]) == 2
        assert math.isfinite(metrics["mAP"])
        np.testing.assert_allclose(
            metrics["mAP"], np.mean([s["mAP"] for s in metrics["seeds"]]))
    assert "+/-" in out and "(seeds: " in out


@pytest.mark.parametrize("trained,kind", [
    ("da_jitter", "plain"),  # CenterRefine nests the backbone a level deeper
    ("da", "da_jitter"),     # BR has no jitter head
])
def test_evaluate_refuses_a_kind_mismatch(fixtures, tmp_path, trained, kind):
    flags = evaluate.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--num_target", "64"])
    model = evaluate.build_model(flags, get_config(flags.dataset), trained)
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    with pytest.raises(SystemExit, match=f"--kind {kind} model"):
        evaluate.main(["--kind", kind, "--checkpoint_path",
                       str(tmp_path / "weights.pt"), "--data_root",
                       str(fixtures[0]), "--num_target", "64",
                       "--device", "cpu"])


@pytest.mark.parametrize("entry,recipe", [
    (votenet_wsb, "wsb"), (votenet_br, "br"),
    (votenet_br_center_refine, "br_center_refine")])
def test_recipes_need_cuda_unless_cpu_asked(fixtures, tmp_path, monkeypatch,
                                            entry, recipe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        entry.main(_recipe_args(fixtures, tmp_path / "log", recipe))


@pytest.mark.parametrize("flag", ["--multihost"])
def test_recipes_refuse_unported_flags(fixtures, tmp_path, monkeypatch,
                                       flag):
    """--multihost is taken, but refused where the environment describes
    no process group (neither the BTR_* nor torchrun's variables)."""
    for name in ("BTR_NUM_PROCESSES", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="BTR_NUM_PROCESSES"):
        votenet_br.main(_recipe_args(fixtures, tmp_path / "log", "br")
                        + ["--device", "cpu", flag])


@pytest.mark.parametrize("flags", [
    ["--bf16", "--f32_tail=2", "--bn_recal_batches=1"],
    ["--bn_recal_batches=2"]])
def test_br_takes_the_precision_and_recal_flags(fixtures, tmp_path, flags):
    """One epoch of BR and its evaluation, the target's BN statistics
    recalibrated before it."""
    log = tmp_path / "log"
    model, _ = votenet_br.main(
        _recipe_args(fixtures, log, "br")
        + ["--device", "cpu", "--max_epoch", "1", "--eval_freq", "1",
           *flags])
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2
    assert math.isfinite(rows[0]["loss"]) and math.isfinite(rows[1]["mAP"])
    assert all(b.dtype == torch.float32 for b in model.buffers())
