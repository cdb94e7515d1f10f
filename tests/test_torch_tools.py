"""The port's last tools against the JAX package's, on the CPU:
``tools/mfu.py``, ``tools/jitter_diag.py``, ``tools/gf_sweep.py`` and the
native box IoU of ``eval/native.py``.

* mfu: the peak tables by device name; the FLOP count of a small VoteNet
  forward equals, exactly, 2 * rows * C_in * C_out summed over every
  product its layers run (the dense layers, and the FP layers' 3-NN
  distance product), as forward hooks record them; ``measure`` on the CPU
  at B=2, N=2048 prints one JSON line with its keys. XLA's cost analysis
  counts otherwise, so the two tools' counts are not compared.
* jitter_diag: a ``da_jitter`` model initialised and saved by the JAX
  package, its ``config.json`` from the JAX parser at N=2048, on a
  jittered synthetic fixture: both tools print ``objects`` equal and every
  other field within 1e-4 (both round to 4 decimals; float32 forwards).
* gf_sweep: both ``main``s with one argv hand ``run_config`` equal flag
  namespaces on their shared keys and the same arms in the same order;
  one real sweep at a small size writes two lines, the exact arm first.
* native: the IoU matrix against the port's Python ``get_iou_obb``
  (1e-9), the port's ``eval_det`` through it against the JAX package's
  (1e-9 a class), two processes building at once both load a whole
  library, and a compiler that fails raises with nothing to fall back to.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from backtoreality_tpu.eval.eval_det import eval_det as jax_eval_det
from backtoreality_tpu.tools import gf_sweep as jax_gf_sweep
from backtoreality_tpu.tools import jitter_diag as jax_jitter_diag
from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
from backtoreality_tpu_torch.eval.eval_det import eval_det as port_eval_det
from backtoreality_tpu_torch.eval import native
from backtoreality_tpu_torch.eval.box3d import get_3d_box, get_iou_obb
from backtoreality_tpu_torch.nn.sa_fp import FPModule
from backtoreality_tpu_torch.tools import gf_sweep, jitter_diag, mfu

B, N, NUM_PROPOSAL = 2, 2048, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    """Four scans of more than N points (no point drawn twice)."""
    d = tmp_path_factory.mktemp("torch_tools_scans")
    write_synthetic_scans(d, get_config("scannet_md40"), num_scans=4,
                          num_objects=4, points_per_object=400,
                          floor_points=800, seed=3)
    return d


# ---------------------------------------------------------------------------
# mfu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind, peaks, hbm", [
    ("NVIDIA H100 80GB HBM3", (989.4, 66.9), 3350.0),
    ("NVIDIA H100 PCIe", (756.0, 51.2), 2000.0),
    ("cpu", (0.1, 0.05), 50.0),
    ("NVIDIA A100-SXM4-40GB", (None, None), None),
])
def test_mfu_peak_lookup(kind, peaks, hbm):
    assert mfu._peaks(kind) == peaks
    assert mfu._hbm_peak(kind) == hbm


def test_mfu_flops_are_the_product_layers(scans):
    """FlopCounterMode over a VoteNet forward (the hand kernels' plain
    versions opaque) against forward hooks on every product."""
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.models.votenet import VoteNet

    cfg = get_config("scannet_md40")
    ds = DetectionDataset(cfg, scans, split="all", num_points=N,
                          use_height=True)
    pc = torch.from_numpy(np.stack([ds.get(i)["point_clouds"]
                                    for i in range(B)]))
    torch.manual_seed(0)
    model = VoteNet(num_class=cfg.num_class,
                    num_heading_bin=cfg.num_heading_bin,
                    num_size_cluster=cfg.num_size_cluster,
                    mean_size_arr=cfg.mean_size_arr, input_feature_dim=1,
                    num_proposal=NUM_PROPOSAL).eval()
    products = []

    def dense(mod, args, out):
        rows = args[0].numel() // mod.in_features
        products.append(2 * rows * mod.in_features * mod.out_features)

    def three_nn(mod, args, out):
        unknown, known = args[0], args[1]
        products.append(2 * unknown.shape[0] * unknown.shape[1]
                        * known.shape[1] * 3)

    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            m.register_forward_hook(dense)
        elif isinstance(m, FPModule):
            m.register_forward_hook(three_nn)
    with torch.no_grad():
        flops, nbytes = mfu.count_step(lambda: model(pc))
    assert len(products) > 20
    assert flops == sum(products)
    assert nbytes > pc.numel() * 4


def test_mfu_measure_prints_one_json_line(capsys):
    out = mfu.measure("votenet", iters=1, device="cpu", batch_size=B,
                      num_points=N)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    for key in ("flops_per_step", "bytes_per_step", "achieved_tflops",
                "achieved_gbs", "step_ms", "pct_of_f32_peak",
                "pct_of_bf16_peak", "pct_of_hbm_peak", "counted"):
        assert key in out, key
    assert out["device_kind"] == "cpu" and out["batch"] == B
    assert out["flops_per_step"] > 0 and out["bytes_per_step"] > 0
    assert all(out[k] > 0 for k in ("pct_of_f32_peak", "pct_of_hbm_peak"))


# ---------------------------------------------------------------------------
# jitter_diag
# ---------------------------------------------------------------------------


def test_jitter_diag_matches_jax(scans, tmp_path):
    import jax
    import jax.numpy as jnp

    from backtoreality_tpu.train import common as jcommon
    from backtoreality_tpu.train import votenet as jvotenet

    parser = argparse.ArgumentParser()
    jvotenet.add_common_flags(parser)
    parser.add_argument("--center_jitter", type=float, default=0.1)
    flags = parser.parse_args(["--num_point", str(N), "--num_target",
                               str(NUM_PROPOSAL), "--batch_size", str(B)])
    config = tmp_path / "config.json"
    config.write_text(json.dumps(vars(flags)))
    cfg = get_config("scannet_md40")
    model = jvotenet.build_model(flags, cfg, "da_jitter")
    sample = (jnp.linspace(-1.0, 1.0, N * 4).reshape(1, N, 4),
              jnp.zeros((1, cfg.max_num_obj, 3)),
              jnp.zeros((1, cfg.max_num_obj), jnp.int32))
    state = jvotenet.init_state(model, jcommon.make_optimizer("adam"),
                                sample, jax.random.PRNGKey(0))
    ckpt = tmp_path / "train_BR_CenterRefine.tar"
    jcommon.save_checkpoint(ckpt, state, 3)

    argv = ["--ckpt", str(ckpt), "--config", str(config), "--data_root",
            str(scans), "--cpu"]
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = ["jitter_diag", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            jax_jitter_diag.main()
    finally:
        sys.argv = saved
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    got = jitter_diag.main(argv)
    assert set(got) == set(want)
    assert got["objects"] == want["objects"] > 0
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-4 + 1e-12, key


# ---------------------------------------------------------------------------
# gf_sweep
# ---------------------------------------------------------------------------


def _recorded_arms(module, monkeypatch, argv):
    calls = []

    def record(flags, fps_candidates, seeds, out_path, logger):
        calls.append((dict(vars(flags)), fps_candidates, list(seeds),
                      out_path.name))
        return []

    monkeypatch.setattr(module, "run_config", record)
    module.main(argv)
    return calls


@pytest.mark.parametrize("skip_exact", [False, True])
def test_gf_sweep_flags_and_arms_match_jax(tmp_path, monkeypatch,
                                           skip_exact):
    argv = ["--data_root", "train", "--val_data_root", "val", "--out",
            str(tmp_path), "--seeds", "0", "1", "--candidates", "1024",
            "4096", "--max_epoch", "50", "--num_point", "3000"]
    if skip_exact:
        argv.append("--skip_exact")
    port = _recorded_arms(gf_sweep, monkeypatch, argv)
    ref = _recorded_arms(jax_gf_sweep, monkeypatch, argv)
    want_arms = ([] if skip_exact else [None]) + [1024, 4096]
    assert [c[1] for c in port] == [c[1] for c in ref] == want_arms
    for (pf, _, pseeds, pout), (jf, _, jseeds, jout) in zip(port, ref):
        shared = sorted(set(pf) & set(jf))
        assert len(shared) > 40
        assert {k: pf[k] for k in shared} == {k: jf[k] for k in shared}
        assert pseeds == jseeds == [0, 1] and pout == jout == "sweep.jsonl"
    assert port[0][0]["lr_decay_epochs"] == [35, 43]


def test_gf_sweep_runs_both_arms(tmp_path):
    root = tmp_path / "scans"
    write_synthetic_scans(root, get_config("scannet_md40"), num_scans=B,
                          num_objects=3, points_per_object=300,
                          floor_points=800, seed=0)
    gf_sweep.main(["--data_root", str(root), "--val_data_root", str(root),
                   "--out", str(tmp_path / "out"), "--seeds", "0",
                   "--candidates", "1024", "--max_epoch", "1",
                   "--num_point", str(N), "--num_target", str(NUM_PROPOSAL),
                   "--num_decoder_layers", "1", "--batch_size", str(B),
                   "--device", "cpu"])
    lines = [json.loads(line) for line in
             (tmp_path / "out" / "sweep.jsonl").read_text().splitlines()]
    assert [r["fps_candidates"] for r in lines] == [None, 1024]
    for r in lines:
        assert r["seed"] == 0
        assert all(np.isfinite(r[k]) for k in ("mAP@0.25", "AR@0.25",
                                               "mAP@0.50", "AR@0.50"))


# ---------------------------------------------------------------------------
# native box IoU
# ---------------------------------------------------------------------------


def _boxes(rng, k):
    return np.stack([get_3d_box(rng.uniform(0.2, 2.0, 3),
                                rng.uniform(-np.pi, np.pi),
                                rng.uniform(-1.0, 1.0, 3))
                     for _ in range(k)])


def test_native_iou_matrix_is_get_iou_obb():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 24), _boxes(rng, 17)
    got = native.box3d_iou_matrix(a, b)
    want = np.array([[get_iou_obb(x, y) for y in b] for x in a])
    assert (want > 0).sum() > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_native_eval_det_matches_jax():
    rng = np.random.default_rng(1)
    pred, gt = {}, {}
    for img in range(6):
        boxes = _boxes(rng, 5)
        gt[img] = [(int(c), box) for c, box in zip(rng.integers(0, 3, 5),
                                                   boxes)]
        dets = [(c, box + rng.normal(0, 0.05, box.shape), rng.random())
                for c, box in gt[img]]
        dets += [(int(c), box, rng.random()) for c, box in zip(
            rng.integers(0, 3, 4), _boxes(rng, 4))]
        pred[img] = dets
    for t in (0.25, 0.5):
        _, _, got = port_eval_det(pred, gt, ovthresh=t)
        _, _, want = jax_eval_det(pred, gt, ovthresh=t)
        assert set(got) == set(want) == {0, 1, 2}
        for c in want:
            assert abs(got[c] - want[c]) <= 1e-9, (t, c)


def test_native_builds_race_free(tmp_path):
    """Two processes that find no library build it at once; each loads a
    whole one (each compiler writes a file of its own, renamed into
    place)."""
    code = (
        "import pathlib, sys, numpy as np\n"
        "from backtoreality_tpu_torch.eval import native\n"
        "from backtoreality_tpu_torch.eval.box3d import get_3d_box\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "box = get_3d_box((1.0, 2.0, 0.5), 0.3, (0.0, 0.0, 0.0))[None]\n"
        "print(native.box3d_iou_matrix(box, box)[0, 0])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert abs(float(out) - 1.0) < 1e-12
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "COMPILER",
                        [sys.executable, "-c",
                         "import sys; print('no compiler here');"
                         " sys.exit(3)"])
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.load()
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 3)
    pred = {0: [(0, b, 0.5) for b in boxes]}
    gt = {0: [(0, b) for b in boxes]}
    with pytest.raises(RuntimeError, match="failed"):
        port_eval_det(pred, gt)
    # a caller's own get_iou_func takes the Python loop
    _, _, ap = port_eval_det(
        pred, gt, get_iou_func=lambda a, b: get_iou_obb(a, b))
    assert ap[0] == pytest.approx(1.0)
    assert list(tmp_path.iterdir()) == []
