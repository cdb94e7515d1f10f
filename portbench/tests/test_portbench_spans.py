"""The span stretch's reduction (``portbench/spans.py``) on made-up Chrome
trace events: an idle interval split across two spans and
``unattributed``, self time with nested children, launches by span from
two threads, the fallback's scaling; and, on one canned trace with and
without the program's ranges, every per-layer reader and the idle gaps
of ``portbench/trace.py`` reading the same."""

import json
import types

import pytest

from portbench import harness, spans, trace
from portbench.harness import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": args.pop("tid", 1), "args": args}


def _ua(name, ts, dur, tid=1):
    return _x("user_annotation", name, ts, dur, tid=tid)


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr,
              tid=tid)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, correlation=corr)


def test_idle_split_across_two_spans_and_unattributed():
    """A unit [0, 100) holding ``model`` [10, 40) with ``model.backbone``
    [15, 30) in it, then ``loss`` [40, 60); kernels keep the device busy
    over [0, 20) and [55, 100). The idle [20, 55) splits into 10 us in
    ``model.backbone``, 10 in ``model``, 15 in ``loss``; with ``loss``
    ending at 50 instead, its last 5 us are unattributed inside the
    unit."""
    events = [_ua(trace.UNIT, 0, 100), _ua("model", 10, 30),
              _ua("model.backbone", 15, 15), _ua("loss", 40, 20),
              _launch(0, 1), _kernel("a", 0, 20, 1),
              _launch(50, 2), _kernel("b", 55, 45, 2)]
    got = spans.reduce(events, 1)
    assert got["idle"] == pytest.approx(
        {"model.backbone": 10e-6, "model": 10e-6, "loss": 15e-6})
    assert got["layer_idle"] == pytest.approx({"model": 20e-6,
                                               "loss": 15e-6})
    assert got["window_s"] - got["busy_s"] == pytest.approx(35e-6)
    events[3] = _ua("loss", 40, 10)
    got = spans.reduce(events, 1)
    assert got["idle"] == pytest.approx(
        {"model.backbone": 10e-6, "model": 10e-6, "loss": 10e-6,
         spans.UNATTRIBUTED: 5e-6})
    assert got["unattributed_in_units"] == pytest.approx(5e-6)
    assert sum(got["idle"].values()) == pytest.approx(
        got["window_s"] - got["busy_s"])
    assert spans.idle_ms(got, "loss") == pytest.approx(10e-3)
    assert spans.idle_ms(got, "step.optimizer") is None  # never recorded


def test_a_loss_inside_the_model_counts_to_loss():
    events = [_ua(trace.UNIT, 0, 100), _ua("model", 0, 100),
              _ua("loss", 40, 20), _ua("loss.vote", 45, 10),
              _launch(0, 1), _kernel("a", 0, 40, 1),
              _launch(1, 2), _kernel("b", 60, 40, 2)]
    got = spans.reduce(events, 2)
    assert got["layer_idle"] == pytest.approx({"loss": 20e-6})
    assert got["idle"] == pytest.approx({"loss": 10e-6, "loss.vote": 10e-6})
    assert spans.idle_ms(got, "loss") == pytest.approx(10e-3)  # 2 units
    assert spans.idle_ms(got, "model") == 0.0


def test_self_time_with_nested_children():
    """``step`` [0, 100) holds ``model`` [10, 50), which holds
    ``model.backbone`` [12, 30) and ``model.voting`` [30, 45); on another
    thread ``kernel.group.backward`` [60, 70): self times 60, 7, 18, 15
    and 10 us."""
    events = [_ua(trace.UNIT, 0, 100), _ua("step", 0, 100),
              _ua("model", 10, 40), _ua("model.backbone", 12, 18),
              _ua("model.voting", 30, 15),
              _ua("kernel.group.backward", 60, 10, tid=2),
              _launch(0, 1), _kernel("a", 0, 100, 1)]
    got = spans.reduce(events, 1)
    assert got["host"] == pytest.approx(
        {"step": 60e-6, "model": 7e-6, "model.backbone": 18e-6,
         "model.voting": 15e-6, "kernel.group.backward": 10e-6})
    assert got["spans"] == 5
    assert spans.breakdown(got, top=2)["host_spans"] == [
        ["step", pytest.approx(60e-6)], ["model.backbone",
                                         pytest.approx(18e-6)]]


def test_segments_cut_a_child_at_its_parent():
    pieces = spans.segments([(0, 10, "a"), (5, 12, "b"), (20, 30, "c")])
    assert pieces == [(0, 5, ("a",)), (5, 10, ("a", "b")),
                      (20, 30, ("c",))]


def test_launches_by_span_from_two_threads():
    """Launches on the units' thread in ``kernel.fps`` (inside ``model``),
    in ``model``, outside any span; on autograd's thread one in
    ``kernel.group.backward`` and one in no span of its own, which counts
    to ``step.backward``; a call whose work never reached the device (a
    synchronise) is no launch."""
    events = [_ua(trace.UNIT, 0, 200), _ua("model", 10, 90),
              _ua("kernel.fps", 20, 10),
              _ua("kernel.group.backward", 120, 10, tid=2),
              _launch(25, 1), _kernel("fps_reg_kernel", 26, 5, 1),
              _launch(50, 2), _kernel("k", 51, 5, 2),
              _launch(150, 3), _kernel("k", 151, 5, 3),
              _launch(121, 4, tid=2), _kernel("group_bwd_fold_kernel",
                                               122, 5, 4),
              _launch(140, 5, tid=2), _kernel("k", 141, 5, 5),
              _x("cuda_runtime", "cudaDeviceSynchronize", 190, 10,
                 correlation=6)]
    got = spans.reduce(events, 1)
    assert got["launches"] == {"kernel.fps": 1, "model": 1,
                               spans.UNATTRIBUTED: 1,
                               "kernel.group.backward": 1,
                               "step.backward": 1}


def test_fallback_scaling():
    """A stretch whose idle a unit is twice the device stretch's (host ops
    traced) has each span's idle halved, and the breakdown with it."""
    events = [_ua(trace.UNIT, 0, 100), _ua("model", 0, 60),
              _ua("loss", 60, 40), _launch(0, 1), _kernel("a", 0, 20, 1),
              _launch(1, 2), _kernel("b", 80, 20, 2)]
    got = spans.reduce(events, 1)
    assert got["window_s"] - got["busy_s"] == pytest.approx(60e-6)
    got["scale"] = spans.scale(got, 30e-6)
    assert got["scale"] == pytest.approx(0.5)
    assert spans.idle_ms(got, "model") == pytest.approx(20e-3)
    assert spans.idle_ms(got, "loss") == pytest.approx(10e-3)
    assert spans.breakdown(got)["idle_spans"] == [
        ["model", pytest.approx(20e-6)], ["loss", pytest.approx(10e-6)]]


def _canned(program: bool) -> list:
    """Two training units on thread 1 with host ops, launches of FPS,
    query, grouping and other kernels, a copy, an optimizer range, and
    backward launches from thread 2; with `program`, the program's spans
    over them, on both threads."""
    events = [_x("cuda_runtime", "cudaDeviceSynchronize", -10, 10)]
    for u, base in enumerate((0, 1000)):
        c = 10 * u
        events += [
            _ua(trace.UNIT, base, 900),
            _x("cpu_op", "aten::mm", base + 50, 60),
            _x("cpu_op", "aten::mul", base + 300, 150),
            _ua("Optimizer.step#Adam.step", base + 700, 150),
            _launch(base + 1, c + 1),
            _kernel("void fps_reg_kernel<16, true>", base + 5, 100, c + 1),
            _launch(base + 110, c + 2),
            _kernel("void bq_centres_kernel<2>", base + 120, 50, c + 2),
            _launch(base + 180, c + 3),
            _kernel("group_rows_kernel", base + 190, 40, c + 3),
            _launch(base + 320, c + 4),
            _kernel("sm80_xmma_gemm", base + 330, 80, c + 4),
            _x("gpu_memcpy", "Memcpy DtoD", base + 420, 20),
            _launch(base + 500, c + 5, tid=2),
            _kernel("group_bwd_fold_kernel", base + 510, 90, c + 5),
            _launch(base + 710, c + 6),
            _kernel("multi_tensor_apply_kernel", base + 720, 100, c + 6)]
        if program:
            events += [
                _ua("step", base + 1, 890), _ua("model", base + 1, 300),
                _ua("model.backbone", base + 1, 250),
                _ua("kernel.fps", base + 1, 3),
                _ua("kernel.ball_query", base + 110, 5),
                _ua("kernel.group", base + 180, 5),
                _ua("loss", base + 310, 150),
                _ua("loss.box_sem", base + 320, 100),
                _ua("step.backward", base + 470, 220),
                _ua("kernel.group.backward", base + 499, 5, tid=2),
                _ua("step.optimizer", base + 695, 160)]
    events.append(_x("cuda_runtime", "cudaDeviceSynchronize", 1950, 10))
    return events


def _outcome(kind, data):
    return harness.Outcome(
        kind=kind, setup_s=3.0, units=10, wall=2.0, scenes=80,
        attempted=10, failed=0, latencies=[0.01 * i for i in range(1, 50)],
        trace=data, flops_per_unit=1e12, memory_peak_bytes=0, numbers={},
        peaks=(66.9e12, 3.35e12),
        work=types.SimpleNamespace(bound_ms=lambda kinds, peaks: 0.05))


def _readings(events):
    data = trace.TraceData(trace.device_stretch(events, 2),
                           trace.attribution_stretch(events, 2))
    values = {}
    for kind in ("train", "serve"):
        out = _outcome(kind, data)
        for m in BENCH["per_layer"] + BENCH["end_to_end"]:
            values[(kind, m["name"])] = harness.reader(m["name"])(out)
    return values, data.breakdown()


def test_program_ranges_leave_the_trace_readers_as_they_were():
    without, gaps_without = _readings(_canned(False))
    with_spans, gaps_with = _readings(_canned(True))
    per_layer = [m["name"] for m in BENCH["per_layer"]]
    assert len(per_layer) == 13
    assert all(without[("train", n)] is not None or without[("serve", n)]
               is not None for n in per_layer)
    assert with_spans == without
    assert gaps_with == gaps_without
    assert gaps_without["idle_gaps"]  # the canned trace has idle gaps


def test_canned_spans_cover_the_steps():
    got = spans.reduce(_canned(True), 2)
    idle = got["window_s"] - got["busy_s"]
    assert sum(got["idle"].values()) == pytest.approx(idle)
    assert got["unattributed_in_units"] < 0.05 * idle
    assert set(got["layer_idle"]) <= set(spans.LAYERS.values())
    without = spans.reduce(_canned(False), 2)
    assert spans.idle_ms(without, "model") is None
    assert without["idle"] == {spans.UNATTRIBUTED: pytest.approx(idle)}
