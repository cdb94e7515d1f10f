"""The numbers that decide ``correct``, and their limits.

Training (the first three steps, which set-up drives through the
window's own call on three batches that share no row; the reference
takes step 1 from the benchmark's weights and steps 2 and 3 from the
system's state before them):

* ``loss_gap``: the largest over the three steps of |loss - reference
  loss| / |reference loss|;
* ``grad_gap``: each update's gradient as the optimizer took it (after
  the clip, where there is one), leaf by leaf, |norm - reference norm|
  over the larger of the reference's norm of that leaf and of the median
  leaf; the worst leaf of the three steps;
* ``change_gap``: the same of each parameter's change over the three
  steps, leaving out what moves by round-off alone: the leaves whose
  first reference gradient is under a thousandth of the median leaf's,
  and in the others the elements whose first reference gradient is
  under a thousandth of the median leaf's root mean square (Adam's first
  update is lr times the gradient's sign, so an element whose gradient is
  nought to rounding moves by lr one way or the other).

Serving (a sample of the window's requests, drawn from the seed):

* ``out_gap``: the largest over the sampled requests and the outputs the
  box parser reads of max |output - reference| / max |reference|.

A cell's limits are in ``portbench/limits/<cell>.json``; a number above
its limit, or not finite, makes the run not correct.
"""

from __future__ import annotations

import math

import torch


def rel_gap(value: float, ref: float) -> float:
    return abs(value - ref) / abs(ref)


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's |norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf (inf where one
    is not finite)."""
    norms = {n: torch.linalg.vector_norm(r.double()).item()
             for n, r in ref.items()}
    median = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for n, r in norms.items():
        p = torch.linalg.vector_norm(prog[n].double()).item()
        gap = abs(p - r) / max(r, median)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def moved(ref_grads: dict) -> dict:
    """name -> mask of the elements that count in the change: the leaves
    whose reference gradient is at least a thousandth of the median
    leaf's, and in them the elements at least a thousandth of the median
    leaf's root mean square."""
    norms = {n: torch.linalg.vector_norm(g.double()).item()
             for n, g in ref_grads.items()}
    rms = {n: v / math.sqrt(ref_grads[n].numel()) for n, v in norms.items()}
    median = sorted(norms.values())[len(norms) // 2]
    median_rms = sorted(rms.values())[len(rms) // 2]
    return {n: ref_grads[n].abs() >= 1e-3 * median_rms
            for n, v in norms.items() if v >= 1e-3 * median}


def out_gap(prog: dict, ref: dict) -> float:
    worst = 0.0
    for k, r in ref.items():
        r = r.double()
        p = prog[k].double().to(r.device)
        scale = torch.amax(torch.abs(r)).item()
        gap = torch.amax(torch.abs(p - r)).item() / max(scale, 1e-30)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def verdict(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())
