"""The benchmark of ``backtoreality_tpu_torch``: one run of one cell.

A cell of ``BENCHMARK.json`` names a configuration
(``portbench/configs/<config>.json``: the model's sizes, the system's
flags, the family whose hooks drive it, ``portbench/families/
<family>.py``) and a traffic mix (``portbench/traffic/<traffic>.json``:
the mode, ``portbench/modes/<mode>.py``, the batch, the pool, the scene
recipe). Every metric of the file is read by ``portbench/metrics/
<name>.py``, and the cell's limits are ``portbench/limits/<cell>.json``.
So a later change adds a configuration, a cell, a mode or a metric as
files of its own.

A run: the cell's inputs and weights from ``--seed``, set-up (the
kernels are built once into the checkout's ``build/kernels/``), the
measured window of ``--seconds``, with ``--trace 1`` a profiled stretch
after it and a counting pass, then the comparison with the plain
reference in ``portbench/reference/``; the last line of standard output
is the result, the numbers compared and their limits the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "backtoreality_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, traffic
    and limits loaded."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {"entry": entry,
            "config": load_json(ROOT / config["file"]),
            "traffic": load_json(BENCH / "traffic" /
                                 f"{entry['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json")}


def metrics_of(name: str, kind: str, bench: dict) -> list[dict]:
    """The metrics of `kind` (end_to_end or per_layer) the cell reports:
    those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Outcome(types.SimpleNamespace):
    """What a mode's run hands back: kind, setup_s, units, wall, scenes,
    attempted, failed, and where measured latencies, trace, work,
    flops_per_unit, memory_peak_bytes, numbers; `peaks` is set by the
    harness."""


class Context:
    """What a mode gets: the cell's files, the family's hooks, the run's
    arguments and device."""

    def __init__(self, name, loaded, seed, seconds, trace, device, t0):
        self.name = name
        self.config = loaded["config"]
        self.traffic = loaded["traffic"]
        self.limits = loaded["limits"]
        self.family = importlib.import_module(
            f"portbench.families.{self.config['family']}")
        self.mode = importlib.import_module(
            f"portbench.modes.{self.traffic['mode']}")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0
        self.fault = None  # a fault of portbench/faults.py, for its tests

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def note(self, what: str):
        """A line on standard error with the seconds since the process
        started: where set-up and the comparison spend their time."""
        import time

        print(f"[{time.perf_counter() - self.t0:9.3f} s] {what}",
              file=sys.stderr, flush=True)

    def outcome(self, **kw) -> Outcome:
        return Outcome(latencies=None, trace=None, work=None,
                       flops_per_unit=None, memory_peak_bytes=0,
                       numbers={}, peaks=None, **kw)


def result(ctx: Context, out: Outcome, bench: dict,
           device_info: dict) -> dict:
    """The result line: correct, attempted, failed, metrics, device, with a
    trace the breakdown, and last the numbers compared with their
    limits."""
    from portbench import compare

    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in metrics_of(ctx.name, kind, bench):
        value = reader(m["name"])(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": compare.verdict(out.numbers, ctx.limits),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device_info}
    if ctx.trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": ctx.limits[k]}
                      for k, v in out.numbers.items()}
    return line


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args, t0: float) -> dict:
    """Run the cell on the card; returns the result line. Refuses to run
    without as many CUDA cards as the cell names."""
    import torch

    from portbench import peaks

    bench = benchmark()
    loaded = cell(args.workload, bench)
    chips = loaded["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise SystemExit(f"{args.workload} needs {chips} CUDA device(s);"
                         " none or too few are available")
    device = torch.device("cuda", 0)
    from backtoreality_tpu_torch.train import common

    # what every trainer of the system runs under
    common.make_deterministic()
    common.resolve_device(str(device))
    ctx = Context(args.workload, loaded, args.seed, args.seconds,
                  bool(args.trace), device, t0)
    out = ctx.mode.run(ctx)
    kind = torch.cuda.get_device_name(device)
    out.peaks = peaks.of(kind)
    info = {"platform": "gpu", "kind": kind, "count": chips,
            "memory_peak_bytes": out.memory_peak_bytes}
    if ctx.trace:
        info["busy_s"] = out.trace.busy_s
        info["window_s"] = out.trace.window_s
    return result(ctx, out, bench, info)


def main(argv, t0: float) -> int:
    args = parse(argv)
    line = execute(args, t0)
    found = forbidden_modules()
    if found:
        print("refused: the process holds " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, check in line["checks"].items():
        ok = math.isfinite(check["value"]) and check["value"] <= check[
            "limit"]
        print(f"check {name} {check['value']!r} limit {check['limit']!r}"
              f" {'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(finite(line), allow_nan=False), flush=True)
    return 0


def finite(tree):
    """`tree` with every float that is not finite written as a string."""
    if isinstance(tree, dict):
        return {k: finite(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [finite(v) for v in tree]
    if isinstance(tree, float) and not math.isfinite(tree):
        return repr(tree)
    return tree
