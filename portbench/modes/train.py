"""Training cells: the system's train step back to back on a pool of
batches staged on the card.

Set-up makes the pool and the weights from the seed, builds the step
(model, optimizer, criterion) and drives it through its first three
steps on pool batches 0, 1 and 2, which share no row: they warm up every
shape and are the steps the reference checks. Before each of them the
state is kept (parameters, Adam's moments and count, the dropout
generator's state), and after it the loss and the gradients the optimizer
took. The window then runs the same step on the pool in turn from batch
3, and reads the losses once, after a synchronise at its end.
``train_scenes_per_s`` counts every scene of every step over the window's
wall.

The reference takes step 1 from the benchmark's weights, and steps 2 and
3 from the system's state before them: from random weights the detectors'
losses hang on discrete choices (objectness labels, box assignments, FPS
on the votes) that a rounding flips, so two sound three-step runs part
by tens of percent at step 3, and only a step from one state has a
steady reading.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import compare, traffic, weights, work

FIRST_STEPS = 3


def _to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _host(tensors: dict) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


class Session:
    """The system's side of a training cell."""

    def __init__(self, ctx, fault=None):
        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        self.host_pool = traffic.pool(ctx.seed, tr, cfg)
        ctx.note("pool made")
        self.pool = [_to_device(b, ctx.device) for b in self.host_pool]
        self.shapes = ctx.family.shapes(cfg)
        (self.model, step, self.optimizer,
         self.generator) = ctx.family.program_trainer(
            cfg, ctx.device, weights.make(self.shapes, ctx.seed, ctx.device),
            ctx.seed)
        self.step = step if fault is None else fault(self, step)
        self.names = {p: n for n, p in self.model.named_parameters()}

    def first_steps(self) -> dict:
        """Steps 1-3; returns the state before each (host), each loss, the
        gradients each update took (host), the parameters after step 3."""
        named = dict(self.model.named_parameters())
        states, losses, grads = [], [], []
        for i in range(FIRST_STEPS):
            opt = self.optimizer.state
            states.append({
                "params": _host(named),
                "m": _host({n: opt[p]["exp_avg"] if p in opt
                            else torch.zeros_like(p)
                            for n, p in named.items()}),
                "v": _host({n: opt[p]["exp_avg_sq"] if p in opt
                            else torch.zeros_like(p)
                            for n, p in named.items()}),
                "t": i,
                "generator": (None if self.generator is None
                              else self.generator.get_state())})
            losses.append(self.step(self.pool[i])["loss"])
            grads.append(_host({n: p.grad for n, p in named.items()
                                if p.grad is not None}))
        return {"states": states, "losses": [float(x) for x in losses],
                "grads": grads, "params": _host(named)}

    def unit(self, i: int):
        return self.step(self.pool[(FIRST_STEPS + i) % len(self.pool)])

    def window(self, seconds: float):
        self.ctx.sync()
        losses = []
        t0 = time.perf_counter()
        while True:
            losses.append(self.unit(len(losses))["loss"])
            if time.perf_counter() - t0 >= seconds:
                break
        self.ctx.sync()
        wall = time.perf_counter() - t0
        finite = int(torch.isfinite(torch.stack(losses)).sum().item())
        return len(losses), wall, len(losses) - finite

    def count(self, units: int):
        """One counting pass of `units` steps: the kernels' work and the
        model FLOPs (FlopCounterMode) a step."""
        from torch.utils.flop_counter import FlopCounterMode

        with work.WorkLog() as log, FlopCounterMode(display=False) as flops:
            for i in range(units):
                self.unit(i)
            log.units = units
        self.ctx.sync()
        return log, flops.get_total_flops() / units


def reference_steps(ctx, host_pool, prog: dict, tf32: bool = False) -> dict:
    """The reference's step k from the system's state before it (step 1:
    the benchmark's weights, moments 0), on the same batches; with `tf32`,
    its matrix products in TF32 (the control)."""
    shapes = ctx.family.shapes(ctx.config)
    w = weights.make(shapes, ctx.seed, ctx.device)
    trainer = ctx.family.reference_trainer(ctx.config, ctx.device, w,
                                           ctx.seed)
    start = _host({n: w[n] for n in trainer.opt.params})
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        losses, grads, changes = [], [], []
        for i, state in enumerate(prog["states"]):
            if i:
                trainer.load(*(_to(state[k], ctx.device)
                               for k in ("params", "m", "v")), state["t"],
                             state["generator"])
            loss, taken = trainer.step(_to_device(host_pool[i], ctx.device))
            losses.append(float(loss))
            grads.append(_host(taken))
            after = _host(trainer.opt.params)
            changes.append({n: after[n] - state["params"][n] for n in after})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
    return {"losses": losses, "grads": grads, "start": start,
            "params": {n: start[n] + sum(c[n] for c in changes)
                       for n in start}}


def _to(tensors: dict, device) -> dict:
    return {n: t.to(device) for n, t in tensors.items()}


def numbers(prog: dict, ref: dict) -> dict:
    """loss_gap over the three steps, grad_gap over the three updates'
    gradients, change_gap of the change over the three steps (the
    system's, against the sum of the reference's steps)."""
    loss = max(compare.rel_gap(a, b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    grad = max(compare.leaf_gap(p, r) for p, r in zip(prog["grads"],
                                                       ref["grads"]))
    start = ref["start"]
    moved = compare.moved(ref["grads"][0])
    change = compare.leaf_gap(
        {n: (prog["params"][n] - start[n])[m] for n, m in moved.items()},
        {n: (ref["params"][n] - start[n])[m] for n, m in moved.items()})
    return {"loss_gap": loss if math.isfinite(loss) else math.inf,
            "grad_gap": grad, "change_gap": change}


def run(ctx):
    """One run of a training cell; returns the outcome the harness
    reports."""
    session = Session(ctx, ctx.fault)
    ctx.note("pool, weights and step built")
    prog = session.first_steps()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    ctx.note(f"first steps done, losses {prog['losses']}")
    steps, wall, failed = session.window(ctx.seconds)
    ctx.note(f"window: {steps} steps in {wall} s")
    out = ctx.outcome(kind="train", setup_s=setup_s, units=steps, wall=wall,
                      scenes=steps * ctx.traffic["batch"], attempted=steps,
                      failed=failed)
    if ctx.trace:
        from portbench import trace

        out.trace = trace.collect(session.unit, ctx.traffic["trace_units"])
    if ctx.device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
    if ctx.trace:
        out.work, out.flops_per_unit = session.count(
            min(len(session.pool), ctx.traffic["trace_units"]))
    host_pool = session.host_pool
    del session
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out.numbers = numbers(prog, reference_steps(ctx, host_pool, prog))
    ctx.note("reference compared")
    return out
