"""The port's host side and evaluation entry point, on the CPU.

* The copied dataset, loader, `parse_predictions` and `APCalculator` give
  the JAX package's outputs exactly on the same inputs (they are copies;
  any difference is a bug).
* `evaluate.main` runs end to end on a tiny synthetic fixture with
  ``--device cpu``, and raises without CUDA when no device is given.
* No file of the port, nor chip_smoke.py, imports JAX, the JAX package or
  msgpack.
"""

import argparse
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from backtoreality_tpu.data import scannet_md40_config as jax_config
from backtoreality_tpu.data.dataset import DetectionDataset as JaxDataset
from backtoreality_tpu.data.synthetic import write_synthetic_scans
from backtoreality_tpu.eval import APCalculator as JaxAPCalculator
from backtoreality_tpu.eval import parse_groundtruths as jax_parse_gts
from backtoreality_tpu.eval import parse_predictions as jax_parse_preds
from backtoreality_tpu_torch.data import scannet_md40_config
from backtoreality_tpu_torch.data.dataset import DetectionDataset
from backtoreality_tpu_torch.data.loader import DetectionDataLoader
from backtoreality_tpu_torch.eval import (APCalculator, parse_groundtruths,
                                          parse_predictions)
from backtoreality_tpu_torch.train import evaluate

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUM_POINT = 1000


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_eval_scans")
    write_synthetic_scans(d, jax_config(), num_scans=4, num_objects=3,
                          points_per_object=300, floor_points=800, seed=0)
    return d


def _batch(dataset_cls, cfg, root):
    ds = dataset_cls(cfg, root, split="all", num_points=NUM_POINT,
                     use_height=True)
    return next(iter(DetectionDataLoader(ds, 4, shuffle=False,
                                         prefetch=0)))


def _fake_end_points(cfg, batch, k=32, seed=0):
    """Proposals scattered around the GT centres, random head logits."""
    rng = np.random.default_rng(seed)
    b = batch["center_label"].shape[0]
    nh, ns, nc = cfg.num_heading_bin, cfg.num_size_cluster, cfg.num_class
    gt = batch["center_label"][:, rng.integers(0, 3, k)]
    return {
        "center": (gt + rng.normal(0, 0.1, (b, k, 3))).astype(np.float32),
        "heading_scores": rng.normal(size=(b, k, nh)).astype(np.float32),
        "heading_residuals": rng.normal(
            0, 0.1, (b, k, nh)).astype(np.float32),
        "size_scores": rng.normal(size=(b, k, ns)).astype(np.float32),
        "size_residuals": rng.normal(
            0, 0.1, (b, k, ns, 3)).astype(np.float32),
        "sem_cls_scores": rng.normal(size=(b, k, nc)).astype(np.float32),
        "objectness_scores": rng.normal(size=(b, k, 2)).astype(np.float32),
    }


def test_dataset_copy_matches(scans):
    want = _batch(JaxDataset, jax_config(), scans)
    got = _batch(DetectionDataset, scannet_md40_config(), scans)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_parse_and_ap_match(scans):
    cfg, jcfg = scannet_md40_config(), jax_config()
    batch = _batch(DetectionDataset, cfg, scans)
    end_points = _fake_end_points(cfg, batch)
    port_dict = dict(evaluate.EVAL_CONFIG_DICT, dataset_config=cfg)
    jax_dict = dict(evaluate.EVAL_CONFIG_DICT, dataset_config=jcfg)
    preds = parse_predictions(end_points, port_dict)
    jpreds = jax_parse_preds(end_points, jax_dict)
    assert [len(p) for p in preds] == [len(p) for p in jpreds]
    for scan, jscan in zip(preds, jpreds):
        for (c, box, score), (jc, jbox, jscore) in zip(scan, jscan):
            assert c == jc and score == jscore
            np.testing.assert_array_equal(box, jbox)
    gts = parse_groundtruths(batch, port_dict)
    jgts = jax_parse_gts(batch, jax_dict)
    for t in (0.25, 0.5):
        calc = APCalculator(t, cfg.class2type)
        jcalc = JaxAPCalculator(t, jcfg.class2type)
        calc.step(preds, gts)
        jcalc.step(jpreds, jgts)
        got, want = calc.compute_metrics(), jcalc.compute_metrics()
        assert got == want


def _checkpoint(tmp_path, num_target):
    flags = evaluate.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--num_target", str(num_target)])
    torch.manual_seed(0)
    model = evaluate.build_model(flags, scannet_md40_config())
    path = tmp_path / "votenet.pt"
    torch.save(model.state_dict(), path)
    return path


def test_evaluate_main_cpu(scans, tmp_path, capsys):
    ckpt = _checkpoint(tmp_path, 16)
    results = evaluate.main([
        "--model", "votenet", "--checkpoint_path", str(ckpt),
        "--data_root", str(scans), "--split", "all",
        "--num_point", str(NUM_POINT), "--num_target", "16",
        "--batch_size", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "eval scans: 4" in out
    assert "===== votenet @ IoU 0.25 =====" in out
    assert set(results) == {("", 0.25), ("", 0.5)}
    for metrics in results.values():
        assert math.isfinite(metrics["mAP"]) and math.isfinite(
            metrics["AR"])


def test_evaluate_needs_cuda_unless_cpu_asked(scans, tmp_path, monkeypatch):
    ckpt = _checkpoint(tmp_path, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        evaluate.main(["--checkpoint_path", str(ckpt), "--data_root",
                       str(scans), "--split", "all"])


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|msgpack)\b|\bflax\b"
    r"|\bbacktoreality_tpu\.", re.M)


def test_port_imports_no_jax():
    files = sorted((ROOT / "backtoreality_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    port = ROOT / "backtoreality_tpu_torch"
    for module in ("bridge.py", "datagen/shapes.py", "datagen/library.py",
                   "datagen/shapefix.py", "models/votenet/da.py", "train/votenet_wsb.py",
                   "train/votenet_br.py",
                   "train/votenet_br_center_refine.py",
                   "models/groupfree/__init__.py",
                   "models/groupfree/backbone.py",
                   "models/groupfree/detector.py",
                   "models/groupfree/modules.py",
                   "models/groupfree/transformer.py",
                   "models/groupfree/da.py",
                   "losses/groupfree.py", "train/groupfree.py",
                   "train/gf_fsb.py", "train/gf_wsb.py", "train/gf_br.py",
                   "train/gf_br_center_refine.py", "tools/torch_import.py",
                   "tools/parity_fixture.py", "tools/parity_report.py"):
        assert port / module in files, module
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []
