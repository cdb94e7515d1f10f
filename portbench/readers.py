"""What the metric readers of ``portbench/metrics/`` share. A reader
takes a run's outcome and returns its metric, or None where the run has
nothing to read it from (no trace, no counting pass, a card without a
published peak); a share of a peak or a roofline is never made up as 0.
"""

from __future__ import annotations

import re
import statistics

# the system's point-cloud kernels by name (csrc/*.cu)
FPS_KERNELS = re.compile(r"\bfps_(reg|capacity)_kernel\b")
QUERY_KERNELS = re.compile(r"\bbq_(centres|points)_kernel\b")
GROUP_KERNELS = re.compile(
    r"\bgroup_(rows|narrow|bwd_lists|bwd_fold|bwd_reduce|localize_tail)"
    r"_kernel\b")


def rate(out, kind: str):
    """Scenes a second over the window, for a run of `kind`."""
    if out.kind != kind:
        return None
    return out.scenes / out.wall


def p95_ms(out):
    if out.latencies is None:
        return None
    return statistics.quantiles(out.latencies, n=100,
                                method="inclusive")[94] * 1e3


def mfu(out, kind: str):
    """The model FLOPs of the window's units over its wall, as a share of
    the card's f32 peak."""
    if out.kind != kind or out.flops_per_unit is None or out.peaks is None:
        return None
    return 100.0 * out.flops_per_unit * out.units / out.wall / out.peaks[0]


def phase_ms(out, phase: str):
    if out.trace is None:
        return None
    return out.trace.device_ms(phase=phase)


def roofline(out, kind: str, kinds, *patterns):
    """The least time of the work of `kinds` (``portbench/work.py``) a
    unit, over the device time a unit of the kernels `patterns` name."""
    if out.kind != kind or out.trace is None or out.work is None \
            or out.peaks is None:
        return None
    took = out.trace.device_ms(
        match=lambda name: any(p.search(name) for p in patterns))
    if took <= 0:
        return None
    return 100.0 * out.work.bound_ms(kinds, out.peaks) / took


def launches(out, kind: str):
    if out.kind != kind or out.trace is None:
        return None
    return out.trace.launches


def idle_pct(out, kind: str):
    if out.kind != kind or out.trace is None:
        return None
    return 100.0 * (1.0 - out.trace.busy_s / out.trace.window_s)
