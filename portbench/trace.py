"""Traced stretches of units (steps or requests) after the window, and
what the per-layer readers take from them.

Two stretches of `units` units each, traced after one unit of warm-up
whose events are dropped (its first unit pays the profiler's own start):

* the device stretch, with only the device's activity traced (CUPTI:
  kernels, copies, the CUDA API calls), so that the host runs at close to
  its untraced pace: the busy time (the union of kernel, copy and memset
  intervals), the stretch's length (from the first CUDA call to the last
  device activity's end), the kernels a unit, the device operations that
  took most time;
* the attribution stretch, with the host's ops traced too, each unit in a
  ``portbench.unit`` range: each kernel's phase, ``backward`` where its
  launch came from a thread other than the units' (the autograd
  engine's device thread), ``optimizer`` where it came inside an
  ``Optimizer.step#...`` range (``torch.optim`` records it around its
  hooks too: the clip), else ``forward`` (the forward, the loss and
  whatever the unit runs around them); and the idle gaps, each named by
  the innermost host op running on the units' thread at the gap's
  middle. Host ops traced are slower, so this stretch's idle time is
  read only by name, never as a share.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

UNIT = "portbench.unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class TraceData:
    def __init__(self, device, attributed):
        self.units = device["units"]
        self.window_s = device["window_s"]
        self.busy_s = device["busy_s"]
        self.launches = device["launches"]
        self.top_ops = device["top_ops"]
        self.kernels = attributed["kernels"]  # [(name, dur_us, phase)]
        self.attributed_units = attributed["units"]
        self.gaps = attributed["gaps"]  # {host op: idle seconds}

    def device_ms(self, phase=None, match=None) -> float:
        """Kernel milliseconds a unit of the attribution stretch, of
        `phase` and of names `match` accepts (None: all)."""
        total = sum(dur for name, dur, ph in self.kernels
                    if (phase is None or ph == phase)
                    and (match is None or match(name)))
        return total / 1e3 / self.attributed_units

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[n, s] for n, s in self.top_ops[:top]],
                "idle_gaps": [[n, s] for n, s in collections.Counter(
                    self.gaps).most_common(top)]}


def _trace(unit, units: int, activities, ranges: bool) -> list:
    """The trace's events after the warm-up unit: unit 0 runs first, then
    a ``torch.cuda.synchronize()`` whose end marks the stretch's start,
    then units 1..`units`."""
    from torch.profiler import profile, record_function

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        unit(0)
        torch.cuda.synchronize()
        for i in range(1, units + 1):
            if ranges:
                with record_function(UNIT):
                    unit(i)
            else:
                unit(i)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    marks = sorted(e["ts"] + e["dur"] for e in events
                   if e.get("ph") == "X" and e.get("name")
                   == "cudaDeviceSynchronize")
    if len(marks) < 2:
        raise RuntimeError("the trace holds no synchronise after the"
                           " warm-up unit")
    return [e for e in events if e.get("ph") != "X" or e["ts"] >= marks[0]]


def collect(unit, units: int) -> TraceData:
    """The device stretch and the attribution stretch of ``unit(i)``."""
    from torch.profiler import ProfilerActivity

    device = device_stretch(_trace(unit, units, [ProfilerActivity.CUDA],
                                   False), units)
    attributed = attribution_stretch(_trace(
        unit, units, [ProfilerActivity.CPU, ProfilerActivity.CUDA], True),
        units)
    return TraceData(device, attributed)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _spans(events):
    return [e for e in events if e.get("ph") == "X"]


def device_stretch(events, units: int) -> dict:
    """Busy time, length, kernels a unit and the top device operations of
    a trace of the device's activity alone."""
    spans = _spans(events)
    calls = [e for e in spans if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if not calls or not device:
        raise RuntimeError("the device stretch's trace holds no CUDA call"
                           " or no device activity")
    start = min(e["ts"] for e in calls)
    end = max(e["ts"] + e["dur"] for e in device + calls)
    merged = [(max(s, start), min(e, end)) for s, e in
              _merge([(e["ts"], e["ts"] + e["dur"]) for e in device])]
    by_name = collections.Counter()
    kernels = [e for e in device if e["cat"] == "kernel"]
    for e in kernels:
        by_name[e["name"][:160]] += e["dur"] / 1e6
    return {"units": units, "window_s": (end - start) / 1e6,
            "busy_s": sum(max(e - s, 0) for s, e in merged) / 1e6,
            "launches": len(kernels) / units,
            "top_ops": by_name.most_common()}


def attribution_stretch(events, units: int) -> dict:
    """Each kernel's phase and the idle gaps by host op, from a trace of
    the host's ops and the device's activity."""
    spans = _spans(events)
    unit_spans = [e for e in spans if e.get("name") == UNIT
                  and e.get("cat") in ("user_annotation", "cpu_op")]
    if not unit_spans:
        raise RuntimeError("the trace holds no unit range")
    main = unit_spans[0]["tid"]
    start = min(e["ts"] for e in unit_spans)
    launches = {}
    for e in spans:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], e["ts"])
    opt = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                 if e.get("name", "").startswith("Optimizer.step#")
                 and e["tid"] == main)
    opt_starts = [s for s, _ in opt]

    def phase(corr):
        tid, ts = launches.get(corr, (main, None))
        if tid != main:
            return "backward"
        if ts is not None:
            i = bisect.bisect_right(opt_starts, ts) - 1
            if i >= 0 and ts <= opt[i][1]:
                return "optimizer"
        return "forward"

    kernels, busy = [], []
    end = max(e["ts"] + e["dur"] for e in unit_spans)
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        busy.append((e["ts"], e["ts"] + e["dur"]))
        end = max(end, e["ts"] + e["dur"])
        if e["cat"] == "kernel":
            kernels.append((e["name"], e["dur"],
                            phase(e.get("args", {}).get("correlation"))))
    merged = [(max(s, start), min(e, end)) for s, e in _merge(busy)
              if e > start and s < end]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
                  if e.get("cat") == "cpu_op" and e["tid"] == main)
    host_starts = [s for s, _, _ in host]
    gaps = collections.Counter()
    edges = [start] + [x for s, e in merged for x in (s, e)] + [end]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        name = "host outside any op"
        # the latest-starting op that holds mid is the innermost
        for i in range(bisect.bisect_right(host_starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        gaps[name] += (g1 - g0) / 1e6
    return {"kernels": kernels, "units": units, "gaps": dict(gaps)}
