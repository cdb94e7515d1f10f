"""The harness on the CPU: every file a cell or a metric names loads by
name, every per-layer metric's cell reports the end-to-end metric it
moves, the names and units keep to their alphabet, the work counts give
the bounds ``PERF.md`` quotes, the trace readers give known answers on
made-up events, the result line has the keys the benchmark's contract
names, and a run with a fault planted under its timed path comes out not
correct while an unbroken one comes out correct."""

import json
import re

import pytest
import torch

from portbench import compare, faults, harness, trace, work
from portbench.harness import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
NUMBERS = {"train": {"loss_gap", "grad_gap", "change_gap"},
           "serve": {"out_gap"}}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    loaded = harness.cell(cell)
    assert loaded["config"]["name"] == loaded["entry"]["config"]
    assert loaded["config"]["reduced"] == next(
        c["reduced"] for c in BENCH["configs"]
        if c["name"] == loaded["entry"]["config"])
    ctx = harness.Context(cell, loaded, 1, 1.0, False, torch.device("cpu"),
                          0.0)
    assert callable(ctx.mode.run)
    assert set(loaded["limits"]) == NUMBERS[loaded["traffic"]["mode"]]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads(metric):
    assert callable(harness.reader(metric))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_its_layers_move(cell):
    e2e = {m["name"] for m in harness.metrics_of(cell, "end_to_end", BENCH)}
    layers = harness.metrics_of(cell, "per_layer", BENCH)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (cell, m["name"])


def test_names_and_units():
    configs = [c["name"] for c in BENCH["configs"]]
    for group in ([m["name"] for m in METRICS], CELLS, configs):
        assert len(set(group)) == len(group)
    for name in ([m["name"] for m in METRICS] + CELLS + configs
                 + [w["traffic"] for w in BENCH["workloads"]]):
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_fps_bounds_reproduce_perf():
    """PERF.md's FPS bounds (10 f32 operations a point a sample at 67
    TFLOP/s): GF's SA1 (B=8, N=50000, 2048 samples) 0.1222 ms; the
    VoteNet training sum at the bench configuration (SA1 on 8192
    candidates, SA2-SA4, the vote FPS) 0.0236 ms."""
    peak = 67e12
    sa1 = work.fps(8, 50000, 2048)[0] / peak * 1e3
    assert round(sa1, 4) == 0.1222
    calls = [(8192, 2048), (2048, 1024), (1024, 512), (512, 256),
             (1024, 256)]
    total = sum(work.fps(8, n, m)[0] for n, m in calls) / peak * 1e3
    assert round(total, 4) == 0.0236


def test_tests_needed_counts_to_the_first_hit():
    """Two buckets of 128 over 200 points: a slot that hits at offset k
    needs k + 1 tests, one with no hit its whole bucket (the last one
    holds 72 points)."""
    idx = torch.tensor([[[5, 128 + 9], [0, 0]]], dtype=torch.int32)
    hit = torch.tensor([[[True, True], [False, False]]])
    assert work.tests_needed(idx, hit, 200, 128) == 6 + 10 + 128 + 72
    assert work.ball_query(1, 200, 2, 2, 216)[0] == 9 * 216


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": args.pop("tid", 1), "args": args}


def test_device_stretch_reader():
    """Two units: kernels at [10, 30) and [25, 40) and a copy at
    [60, 70) over a stretch from the first call (at 0) to the last end
    (100): 40 us busy of 100, 2 kernels, 1 a unit."""
    events = [_x("cuda_runtime", "cudaLaunchKernel", 0, 2, correlation=1),
              _x("kernel", "k1", 10, 20, correlation=1),
              _x("cuda_runtime", "cudaLaunchKernel", 5, 2, correlation=2),
              _x("kernel", "k2", 25, 15, correlation=2),
              _x("gpu_memcpy", "Memcpy DtoH", 60, 10),
              _x("cuda_runtime", "cudaDeviceSynchronize", 70, 30)]
    got = trace.device_stretch(events, 2)
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(40e-6)
    assert got["launches"] == 1.0
    assert [n for n, _ in got["top_ops"]] == ["k1", "k2"]


def test_attribution_stretch_reader():
    """A unit on thread 1 with a forward kernel, an optimizer range and a
    kernel launched in it, and a kernel launched from thread 2 (the
    autograd engine's); the idle gap [40, 60) falls inside aten::mul."""
    events = [_x("user_annotation", trace.UNIT, 0, 100),
              _x("cpu_op", "aten::mul", 35, 30),
              _x("user_annotation", "Optimizer.step#Adam.step", 70, 20),
              _x("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
              _x("kernel", "fwd", 2, 38, correlation=1),
              _x("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=2,
                 tid=2),
              _x("kernel", "bwd", 60, 10, correlation=2),
              _x("cuda_runtime", "cudaLaunchKernel", 75, 1, correlation=3),
              _x("kernel", "adam", 76, 24, correlation=3)]
    got = trace.attribution_stretch(events, 1)
    phases = {name: phase for name, _, phase in got["kernels"]}
    assert phases == {"fwd": "forward", "bwd": "backward",
                      "adam": "optimizer"}
    assert got["gaps"] == {"aten::mul": pytest.approx(20e-6),
                           "host outside any op": pytest.approx(8e-6)}


def _outcome(kind, tr=None):
    ctx = harness.Context(
        CELLS[0] if kind == "train" else CELLS[2], harness.cell(
            CELLS[0] if kind == "train" else CELLS[2]), 1, 1.0, tr is not
        None, torch.device("cpu"), 0.0)
    out = ctx.outcome(kind=kind, setup_s=3.0, units=10, wall=2.0,
                      scenes=80, attempted=10, failed=0)
    out.latencies = [0.01 * (i + 1) for i in range(100)]
    out.numbers = {k: 0.0 for k in NUMBERS[kind]}
    out.trace = tr
    return ctx, out


def test_result_line_keys():
    for kind in ("train", "serve"):
        ctx, out = _outcome(kind)
        line = harness.result(ctx, out, BENCH, {"platform": "cpu"})
        assert list(line) == ["correct", "attempted", "failed", "metrics",
                              "device", "checks"]
        assert line["correct"] is True
        assert "setup_s" in line["metrics"]
    tr = trace.TraceData(
        {"units": 2, "window_s": 1.0, "busy_s": 0.75, "launches": 5.0,
         "top_ops": [("k", 0.5)]},
        {"kernels": [("k", 1000.0, "forward")], "units": 2,
         "gaps": {"aten::mul": 0.25}})
    ctx, out = _outcome("train", tr)
    line = harness.result(ctx, out, BENCH, {"platform": "cpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["metrics"]["device_idle_pct.train"]["value"] == 25.0
    assert line["metrics"]["kernel_launches.train"]["value"] == 5.0
    assert line["metrics"]["forward_ms.train"]["value"] == 0.5
    # no peak, no work counted: no share is made up
    assert "mfu.train" not in line["metrics"]
    assert "fps_roofline.train" not in line["metrics"]


def test_p95_is_of_every_request():
    _, out = _outcome("serve")
    assert harness.reader("serve_p95_ms")(out) == pytest.approx(
        950.5, rel=1e-9)
    assert harness.reader("serve_scenes_per_s")(out) == 40.0


@pytest.mark.parametrize("cell,fault", [
    ("votenet-train-b8", None), ("votenet-train-b8", "unchanged"),
    ("votenet-train-b8", "half_batch"), ("votenet-serve-b8", None),
    ("votenet-serve-b8", "half_batch"), ("votenet-serve-b8", "altered"),
    ("gf-train-b32", "half_batch"), ("gf-serve-b32", "altered")])
def test_fault_under_the_timed_path(cell, fault, cpu_context, kernel_query):
    """A whole run but the look for a card, at the small size: correct
    unbroken, not correct with each fault the cell can have."""
    ctx = cpu_context(cell)
    if fault is not None:
        ctx.fault = faults.FAULTS[ctx.traffic["mode"]][fault]
    out = ctx.mode.run(ctx)
    assert out.attempted >= 1 and out.failed == 0
    assert compare.verdict(out.numbers, ctx.limits) is (fault is None), \
        out.numbers
