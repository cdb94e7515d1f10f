"""The readings that the limits of ``portbench/limits/<cell>.json`` are set
from: the numbers ``correct`` compares, read on many seeds in one
process, for the system as it runs (the lower readings), for the control
(the reference in the system's place with its matrix products in TF32,
the precision below the float32 with TF32 off that the configurations
state) and for the system with a fault planted under its timed path.

  python3 portbench/readings.py --workload <cell> --what <what> \
      --seeds <n> [<n> ...] [--seconds <s>]

<what>: ``program``, ``control``, or a fault of ``portbench/faults.py``
that the cell's mode can have (training ``half_batch``; serving
``half_batch``, ``altered``). A state left unchanged by the optimizer
reads 1 on ``change_gap`` by that number's definition and needs no run.
Serving readings run a window of ``--seconds`` (default 2) at the cell's
own load and compare the sample a run compares. Prints one JSON line a
seed; training readings name the leaves of the largest change gaps on
standard error.
"""

import argparse
import json
import pathlib
import random
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, harness, weights  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402
from portbench.modes import serve, train  # noqa: E402


class ControlTrainer:
    """The reference in the system's place for its first three steps, its
    matrix products in TF32: the states, losses and gradients in the form
    ``train.Session.first_steps`` gives them."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.host_pool = train.traffic.pool(ctx.seed, ctx.traffic,
                                            ctx.config)

    def first_steps(self) -> dict:
        ctx = self.ctx
        shapes = ctx.family.shapes(ctx.config)
        trainer = ctx.family.reference_trainer(
            ctx.config, ctx.device,
            weights.make(shapes, ctx.seed, ctx.device), ctx.seed)
        opt = trainer.opt
        states, losses, grads = [], [], []
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            for i in range(train.FIRST_STEPS):
                states.append({
                    "params": train._host(opt.params),
                    "m": train._host(opt.m), "v": train._host(opt.v),
                    "t": opt.t,
                    "generator": (None if trainer.generator is None
                                  else trainer.generator.get_state())})
                loss, taken = trainer.step(train._to_device(
                    self.host_pool[i], ctx.device))
                losses.append(float(loss))
                grads.append(train._host(taken))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        return {"states": states, "losses": losses, "grads": grads,
                "params": train._host(opt.params)}


def read_train(ctx, what: str) -> dict:
    if what == "control":
        session = ControlTrainer(ctx)
    else:
        fault = None if what == "program" else FAULTS["train"][what]
        session = train.Session(ctx, fault)
    prog = session.first_steps()
    host_pool = session.host_pool
    del session
    torch.cuda.empty_cache()
    ref = train.reference_steps(ctx, host_pool, prog)
    numbers = train.numbers(prog, ref)
    ctx.note(f"worst change gaps: {worst_leaves(prog, ref)}")
    return numbers


def worst_leaves(prog: dict, ref: dict, top: int = 3) -> list:
    """The leaves of the largest change gaps, every element counted: (name,
    gap, the system's change norm, the reference's, the median leaf's,
    the reference's first gradient norm, the elements whose change has
    the other sign on the two sides and the largest first reference
    gradient among them, the elements the change leaves out)."""
    start = ref["start"]
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa
    d_p = {n: norm(prog["params"][n] - start[n]) for n in start}
    d_r = {n: norm(ref["params"][n] - start[n]) for n in start}
    median = sorted(d_r.values())[len(d_r) // 2]
    gaps = sorted(((abs(d_p[n] - d_r[n]) / max(d_r[n], median), n)
                   for n in start), reverse=True)[:top]
    g = ref["grads"][0]
    keep = compare.moved(g)
    out = []
    for gap, n in gaps:
        flips = ((prog["params"][n] - start[n]).sign()
                 != (ref["params"][n] - start[n]).sign())
        out.append((n, gap, d_p[n], d_r[n], median, norm(g[n]),
                    int(flips.sum()), float(g[n][flips].abs().max())
                    if flips.any() else None,
                    int((~keep[n]).sum()) if n in keep else "leaf out"))
    return out


def read_serve(ctx, what: str) -> dict:
    rng = random.Random(ctx.seed)
    if what == "control":
        host_pool = serve.traffic.pool(ctx.seed, ctx.traffic, ctx.config)
        picks = [rng.randrange(len(host_pool))
                 for _ in range(ctx.traffic["samples"])]
        kept = list(zip(picks, serve.reference_outputs(
            ctx, host_pool, [(p, None) for p in picks], tf32=True)))
    else:
        fault = None if what == "program" else FAULTS["serve"][what]
        session = serve.Session(ctx, fault)
        for i in range(max(len(session.points), 3)):
            session.unit(i)
        _, _, kept = session.window(ctx.seconds, ctx.traffic["samples"], rng)
        host_pool = session.host_pool
        del session
        torch.cuda.empty_cache()
    return serve.numbers(kept, serve.reference_outputs(ctx, host_pool, kept))


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--what", required=True,
                   choices=("program", "control", "unchanged", "half_batch",
                            "altered"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("readings are taken on the card")
    from backtoreality_tpu_torch.train import common

    common.make_deterministic()
    device = common.resolve_device("cuda")
    loaded = harness.cell(args.workload)
    for seed in args.seeds:
        ctx = harness.Context(args.workload, loaded, seed, args.seconds,
                              False, device, time.perf_counter())
        read = read_train if ctx.traffic["mode"] == "train" else read_serve
        numbers = read(ctx, args.what)
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "seed": seed, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
