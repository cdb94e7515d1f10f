"""The span stretch: units traced with the device's activity and only the
user-scope ranges (the program's spans of ``PERF.md`` §3 and
``portbench.unit``), and its reduction by span.

The program records its spans (``train/observability.span``) only while a
profiler records. A session restricted to ``RecordScope.USER_SCOPE``
records them, the CUDA calls and the device's activity, and no host op,
so that the host keeps close to the device stretch's pace
(``portbench/trace.py``). Its reduction, on the device stretch's own
window (from the first CUDA call to the last device activity's end):

* each idle interval split in time across the innermost program span
  open on the units' thread over each part of it; what no span covers is
  ``unattributed`` (``unattributed_in_units``: the part inside units);
* each span's host self time, its duration less what its child spans
  cover, on every thread;
* the launches (CUDA calls whose work reached the device) by the
  innermost span open on the thread that made them; one from another
  thread (autograd's device thread) with no span of its own counts to
  ``step.backward``.

A session that records no kernel (a build of PyTorch whose user-scope
session leaves CUPTI out) falls back to a session of every host op, as
the attribution stretch is, whose idle runs slower: each span's idle is
then scaled by the device stretch's idle a unit over this stretch's.

Run on the card beside the device stretch, a cell's span stretch:

  python3 portbench/spans.py --workload <cell> --seed <n>

(set-up as the cell's run, an untraced window of ``WINDOW_S``, then the
cell's ``trace_units`` in each stretch) prints one JSON line: the
untraced, device-stretch and span-stretch ms a unit, the idle by span,
the idle by layer (``LAYERS``) in ms a unit, the host self time and the
launches by span, and the spans a unit.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import os
import pathlib
import re
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import trace  # noqa: E402

# the program's span names (PERF.md §3); torch.optim's Optimizer.* ranges
# and the harness's unit are user ranges too, and are not the program's
PROGRAM = re.compile(r"^(step|model|loss|kernel)(\.|$)")
UNATTRIBUTED = "unattributed"
# the spans whose idle (descendants included, the innermost of these
# winning) a per-layer metric reads, by the metric's stem
LAYERS = {"forward_idle_ms": "model", "loss_idle_ms": "loss",
          "backward_idle_ms": "step.backward",
          "optimizer_idle_ms": "step.optimizer"}
WINDOW_S = 5.0


def segments(ranges) -> list:
    """The timeline of one thread's nested ranges [(start, end, name)] as
    pieces [(t0, t1, stack)], `stack` the names open over the piece,
    outermost first; time with no range open is left out. A range that
    ends after its parent is cut at the parent's end."""
    out, stack, t = [], [], None

    def close_until(x):
        nonlocal t
        while stack and stack[-1][0] <= x:
            end = stack[-1][0]
            if end > t:
                out.append((t, end, tuple(n for _, n in stack)))
                t = end
            stack.pop()

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(s)
        if stack and s > t:
            out.append((t, s, tuple(n for _, n in stack)))
        if stack:
            e = min(e, stack[-1][0])
        stack.append((e, name))
        t = s
    close_until(math.inf)
    return out


def split(gaps, pieces) -> collections.Counter:
    """The time of the sorted, disjoint `gaps` [(g0, g1)] by the stack of
    the `pieces` (``segments``) over it; the time no piece covers under
    None."""
    out = collections.Counter()
    i = 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        covered = 0.0
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            overlap = min(g1, pieces[j][1]) - max(g0, pieces[j][0])
            if overlap > 0:
                out[pieces[j][2]] += overlap
                covered += overlap
            j += 1
        rest = (g1 - g0) - covered
        if rest > 1e-9 * (g1 - g0):  # more than the sum's rounding
            out[None] += rest
    return out


def innermost(stack, among=None) -> str:
    """The innermost program span of `stack` (of the names `among`, when
    given), or ``unattributed``."""
    for name in reversed(stack or ()):
        if name != trace.UNIT and (among is None or name in among):
            return name
    return UNATTRIBUTED


def reduce(events, units: int) -> dict:
    """The span stretch's reduction (the module's docstring); times in
    seconds over the whole stretch."""
    spans = [e for e in events if e.get("ph") == "X"]
    units_ranges = [e for e in spans if e.get("name") == trace.UNIT
                    and e.get("cat") == "user_annotation"]
    if not units_ranges:
        raise RuntimeError("the span stretch holds no unit range")
    main = units_ranges[0]["tid"]
    ranges = collections.defaultdict(list)
    for e in spans:
        if e.get("cat") == "user_annotation" and (
                PROGRAM.match(e["name"]) or (e["name"] == trace.UNIT
                                             and e["tid"] == main)):
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"],
                                     e["name"]))
    pieces = {tid: segments(r) for tid, r in ranges.items()}

    calls = [e for e in spans if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")]
    device = [e for e in spans if e.get("cat") in trace.DEVICE_CATS]
    if not calls or not device:
        raise RuntimeError("the span stretch holds no CUDA call or no"
                           " device activity")
    start = min(e["ts"] for e in calls)
    end = max(e["ts"] + e["dur"] for e in device + calls)
    busy = [(max(s, start), min(e, end)) for s, e in trace._merge(
        [(e["ts"], e["ts"] + e["dur"]) for e in device])
        if e > start and s < end]
    edges = [start] + [x for s, e in busy for x in (s, e)] + [end]
    gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2])
            if g1 > g0]
    by_stack = split(gaps, pieces.get(main, []))

    idle = collections.Counter()
    layer_idle = collections.Counter()
    in_units = 0.0
    for stack, us in by_stack.items():
        name = innermost(stack)
        idle[name] += us / 1e6
        if name == UNATTRIBUTED and stack:
            in_units += us / 1e6
        layer = innermost(stack, set(LAYERS.values()))
        if layer != UNATTRIBUTED:
            layer_idle[layer] += us / 1e6

    host = collections.Counter()
    for tid_pieces in pieces.values():
        for t0, t1, stack in tid_pieces:
            name = innermost(stack)
            if name != UNATTRIBUTED:
                host[name] += (t1 - t0) / 1e6

    reached = {e.get("args", {}).get("correlation") for e in device}
    starts = {tid: [p[0] for p in ps] for tid, ps in pieces.items()}
    launches = collections.Counter()
    for e in calls:
        corr = e.get("args", {}).get("correlation")
        if corr is None or corr not in reached:
            continue
        tid, ts = e["tid"], e["ts"]
        name = UNATTRIBUTED
        i = bisect.bisect_right(starts.get(tid, []), ts) - 1
        if i >= 0 and ts < pieces[tid][i][1]:
            name = innermost(pieces[tid][i][2])
        if name == UNATTRIBUTED and tid != main:
            name = "step.backward"
        launches[name] += 1

    seen = {n for r in ranges.values() for _, _, n in r if n != trace.UNIT}
    return {"units": units, "window_s": (end - start) / 1e6,
            "busy_s": sum(max(e - s, 0) for s, e in busy) / 1e6,
            "idle": dict(idle), "unattributed_in_units": in_units,
            "layer_idle": dict(layer_idle), "host": dict(host),
            "launches": dict(launches), "seen": sorted(seen),
            "spans": sum(1 for r in ranges.values() for _, _, n in r
                         if n != trace.UNIT) / units}


def idle_ms(result: dict, span: str):
    """Device idle ms a unit while the units' thread was inside `span`
    (``LAYERS``), scaled where the stretch fell back; None where the
    program recorded no such span."""
    if span not in result["seen"]:
        return None
    return (result["layer_idle"].get(span, 0.0) * result.get("scale", 1.0)
            / result["units"] * 1e3)


def scale(result: dict, device_idle_s_per_unit: float) -> float:
    """The factor that takes the stretch's idle a unit to the device
    stretch's (the fallback's scaling)."""
    ours = (result["window_s"] - result["busy_s"]) / result["units"]
    return device_idle_s_per_unit / ours if ours > 0 else 1.0


def breakdown(result: dict, top: int = 10) -> dict:
    """``idle_spans`` and ``host_spans``: the top `top` spans by idle and
    by host self seconds over the stretch (idle scaled where the stretch
    fell back), in the shape of the trace's ``idle_gaps``."""
    k = result.get("scale", 1.0)
    return {"idle_spans": [[n, s * k] for n, s in collections.Counter(
                result["idle"]).most_common(top)],
            "host_spans": [[n, s] for n, s in collections.Counter(
                result["host"]).most_common(top)]}


def _after_warmup(events) -> list:
    """`events` from the end of the first synchronise on (the one after
    the warm-up unit), as ``trace._trace`` cuts its stretches."""
    marks = sorted(e["ts"] + e["dur"] for e in events
                   if e.get("ph") == "X" and e.get("name")
                   == "cudaDeviceSynchronize")
    if len(marks) < 2:
        raise RuntimeError("the trace holds no synchronise after the"
                           " warm-up unit")
    return [e for e in events if e.get("ph") != "X" or e["ts"] >= marks[0]]


def record(unit, units: int, user_scope: bool = True) -> list:
    """The events of ``unit(0)`` (warm-up, dropped), a synchronise, then
    units 1..`units`, each in a ``portbench.unit`` range; with
    `user_scope`, only user ranges of the host's activity are recorded,
    else every host op."""
    import torch
    from torch._C._autograd import (_disable_profiler, _enable_profiler,
                                    _prepare_profiler)
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, RecordScope,
                                    _ExperimentalConfig)
    from torch.profiler import record_function

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                            False, False, _ExperimentalConfig())
    activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    torch.cuda.synchronize()
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities,
                     {RecordScope.USER_SCOPE} if user_scope else set())
    try:
        unit(0)
        torch.cuda.synchronize()
        for i in range(1, units + 1):
            with record_function(trace.UNIT):
                unit(i)
        torch.cuda.synchronize()
    finally:
        result = _disable_profiler()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        result.save(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return _after_warmup(events)


def collect(unit, units: int, device_idle_s_per_unit: float) -> dict:
    """The span stretch of ``unit(i)`` and its reduction, with the route
    taken (``user_scope``, or ``attribution`` where that session recorded
    no kernel) and the scale of its idle."""
    events = record(unit, units)
    route = "user_scope"
    if not any(e.get("cat") == "kernel" for e in events):
        events = record(unit, units, user_scope=False)
        route = "attribution"
    result = reduce(events, units)
    result["route"] = route
    result["scale"] = (1.0 if route == "user_scope"
                       else scale(result, device_idle_s_per_unit))
    return result


def main(argv) -> int:
    import argparse
    import random
    import time

    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the span stretch is traced on the card")
    from backtoreality_tpu_torch.train import common

    common.make_deterministic()
    device = common.resolve_device("cuda")
    t0 = time.perf_counter()
    ctx = harness.Context(args.workload, harness.cell(args.workload),
                          args.seed, WINDOW_S, True, device, t0)
    units = ctx.traffic["trace_units"]
    session = ctx.mode.Session(ctx)
    if ctx.traffic["mode"] == "train":
        session.first_steps()
        done, wall, _ = session.window(WINDOW_S)
    else:
        for i in range(max(len(session.points), 3)):
            session.unit(i)
        latencies, wall, _ = session.window(WINDOW_S, 1,
                                            random.Random(args.seed))
        done = len(latencies)
    traced = trace.collect(session.unit, units)
    device_idle = (traced.window_s - traced.busy_s) / traced.units
    result = collect(session.unit, units, device_idle)
    idle_s = result["window_s"] - result["busy_s"]
    suffix = "train" if ctx.traffic["mode"] == "train" else "serve"
    stems = LAYERS if suffix == "train" else {"forward_idle_ms": "model"}
    line = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(device),
        "route": result["route"], "scale": result["scale"],
        "untraced_ms_per_unit": wall / done * 1e3,
        "device_stretch_ms_per_unit": traced.window_s / traced.units * 1e3,
        "device_stretch_idle_pct":
            100.0 * (1 - traced.busy_s / traced.window_s),
        "span_stretch_ms_per_unit": result["window_s"] / units * 1e3,
        "span_stretch_idle_pct": 100.0 * idle_s / result["window_s"],
        "idle_sum_over_stretch_idle":
            sum(result["idle"].values()) / idle_s if idle_s else None,
        "unattributed_in_units_share":
            result["unattributed_in_units"] / idle_s if idle_s else None,
        "metrics": {f"{stem}.{suffix}": idle_ms(result, span)
                    for stem, span in stems.items()},
        "spans_per_unit": result["spans"],
        "launches_per_unit": {n: c / units for n, c in sorted(
            result["launches"].items())},
        "idle_gaps": traced.breakdown()["idle_gaps"],
        **breakdown(result)}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
