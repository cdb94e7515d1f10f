"""On the card: the control, the reference in the system's place with
its matrix products in TF32, fails a cell's limits, while the system
passes them, at the CPU tests' small size (2 scans of 2048 points). Run
on the card with ``python -m pytest portbench/tests -m card``; without a
card each test skips. The readings at the cells' own sizes, which the
limits are set from, are ``portbench/readings.py``'s (``PERF.md``)."""

import time

import pytest
import torch

from portbench import compare, harness, readings
from portbench.conftest import small

CELLS = ["votenet-train-b8", "gf-train-b32", "votenet-serve-b8",
         "gf-serve-b32"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_system_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from backtoreality_tpu_torch.train import common

    common.make_deterministic()
    device = common.resolve_device("cuda")
    verdicts = {}
    for what in ("program", "control"):
        ctx = harness.Context(cell, small(cell), 3300000001, 1.0, False,
                              device, time.perf_counter())
        read = (readings.read_train if ctx.traffic["mode"] == "train"
                else readings.read_serve)
        verdicts[what] = compare.verdict(read(ctx, what), ctx.limits)
    assert verdicts == {"program": True, "control": False}
