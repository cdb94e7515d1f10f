"""Serving cells: a closed loop with one request in flight.

A request is one batch of scans in pinned host memory, drawn from a pool
made at set-up from the seed, in turn. Its latency runs from handing the
batch to the system (the copy to the card) until the outputs the box
parser reads (``eval/ap_helper.parse_predictions``'s) are in pinned host
memory: both copies count. The next request starts when one ends. Set-up
serves one request of every pool batch, which warms every shape. A
sample of the window's requests, drawn from the seed as they finish
(reservoir sampling), keeps its outputs for the comparison with the
reference once the window has closed.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import compare, traffic, weights, work


class Session:
    """The system's side of a serving cell."""

    def __init__(self, ctx, fault=None):
        self.ctx = ctx
        self.host_pool = traffic.pool(ctx.seed, ctx.traffic, ctx.config)
        ctx.note("pool made")
        pin = ctx.device.type == "cuda"
        self.points = [torch.from_numpy(b["point_clouds"]) for b in
                       self.host_pool]
        if pin:
            self.points = [p.pin_memory() for p in self.points]
        self.shapes = ctx.family.shapes(ctx.config)
        self.model, forward = ctx.family.program_server(
            ctx.config, ctx.device,
            weights.make(self.shapes, ctx.seed, ctx.device))
        self.forward = forward if fault is None else fault(self, forward)
        self.out = None
        self.pin = pin

    def unit(self, i: int) -> dict:
        """Serve request i (pool batch i mod pool); returns the host
        outputs (buffers that the next request overwrites)."""
        x = self.points[i % len(self.points)].to(self.ctx.device,
                                                 non_blocking=True)
        with torch.inference_mode():
            outs = self.forward(x)
            if self.out is None:
                self.out = {k: torch.empty(v.shape, dtype=v.dtype,
                                           pin_memory=self.pin)
                            for k, v in outs.items()}
            for k, v in outs.items():
                self.out[k].copy_(v, non_blocking=True)
        if self.pin:
            torch.cuda.current_stream(self.ctx.device).synchronize()
        return self.out

    def window(self, seconds: float, samples: int, rng: random.Random):
        """Requests until `seconds` have passed; returns the latencies (s),
        the wall and the sample [(pool index, outputs)]."""
        kept, latencies = [], []
        t0 = time.perf_counter()
        while True:
            i = len(latencies)
            start = time.perf_counter()
            out = self.unit(i)
            end = time.perf_counter()
            latencies.append(end - start)
            j = i if i < samples else rng.randrange(i + 1)
            if j < samples:
                item = (i % len(self.points),
                        {k: v.clone() for k, v in out.items()})
                if i < samples:
                    kept.append(item)
                else:
                    kept[j] = item
            if end - t0 >= seconds:
                break
        return latencies, end - t0, kept

    def count(self, units: int):
        from torch.utils.flop_counter import FlopCounterMode

        with work.WorkLog() as log, FlopCounterMode(display=False) as flops:
            for i in range(units):
                self.unit(i)
            log.units = units
        return log, flops.get_total_flops() / units


def reference_outputs(ctx, host_pool, kept, tf32: bool = False) -> list:
    """The reference's outputs on the sampled requests' batches; with
    `tf32`, its matrix products in TF32 (the control)."""
    shapes = ctx.family.shapes(ctx.config)
    forward = ctx.family.reference_server(
        ctx.config, ctx.device, weights.make(shapes, ctx.seed, ctx.device))
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            return [forward(torch.from_numpy(
                host_pool[p]["point_clouds"]).to(ctx.device))
                for p, _ in kept]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def numbers(kept, refs) -> dict:
    return {"out_gap": max(compare.out_gap(outs, ref)
                           for (_, outs), ref in zip(kept, refs))}


def run(ctx):
    if ctx.traffic["in_flight"] != 1:
        raise ValueError("the serving mode keeps one request in flight")
    session = Session(ctx, ctx.fault)
    ctx.note("pool, weights and model built")
    for i in range(max(len(session.points), 3)):
        session.unit(i)
    setup_s = time.perf_counter() - ctx.t0
    ctx.note("warm-up requests served")
    rng = random.Random(ctx.seed)
    latencies, wall, kept = session.window(ctx.seconds,
                                           ctx.traffic["samples"], rng)
    out = ctx.outcome(kind="serve", setup_s=setup_s, units=len(latencies),
                      wall=wall,
                      scenes=len(latencies) * ctx.traffic["batch"],
                      attempted=len(latencies), failed=0)
    out.latencies = latencies
    lat = sorted(latencies)
    ctx.note(f"window: {len(lat)} requests in {wall} s, latency ms min"
             f" {lat[0] * 1e3} median {lat[len(lat) // 2] * 1e3} max"
             f" {lat[-1] * 1e3}")
    if ctx.trace:
        from portbench import trace

        out.trace = trace.collect(session.unit, ctx.traffic["trace_units"])
    if ctx.device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
    if ctx.trace:
        out.work, out.flops_per_unit = session.count(
            min(len(session.points), ctx.traffic["trace_units"]))
    host_pool = session.host_pool
    del session
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out.numbers = numbers(kept, reference_outputs(ctx, host_pool, kept))
    ctx.note("reference compared")
    return out
