"""Test settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``card`` marker for tests that need a CUDA card
(each decides inside itself whether one is there, and skips otherwise),
and small versions of the cells for the CPU."""

import copy
import importlib
import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def small(name: str) -> dict:
    """Cell `name`'s files at a size the CPU holds: 2 scans of 2048 points
    (3 boxes of 500 points and 600 floor points) a batch, a pool of 3,
    every width as published."""
    from portbench import harness

    loaded = copy.deepcopy(harness.cell(name))
    loaded["config"]["model"]["num_point"] = 2048
    loaded["config"]["flags"]["num_point"] = 2048
    loaded["traffic"].update(batch=2, pool=3, objects=3,
                             points_per_object=500, floor_points=600)
    return loaded


@pytest.fixture
def kernel_query(monkeypatch):
    """The system's CPU stand-in for the ball query with the kernel's
    radius test (the reference's): the stand-in sums c.p by a matrix
    product and so differs from the card at points within rounding of
    the radius, which at random weights moves later discrete choices."""
    from portbench.reference import ops as ref_ops

    bq = importlib.import_module("backtoreality_tpu_torch.ops.ball_query")
    monkeypatch.setattr(bq, "_ball_query_stratified_torch",
                        lambda xyz, c, r, n: ref_ops.ball_query_stratified(
                            xyz, c, r, n))


@pytest.fixture
def cpu_context():
    """context(name, seed) -> a harness Context of the small cell on the
    CPU, under the system's determinism switch."""
    import torch

    from backtoreality_tpu_torch.train import common
    from portbench import harness

    common.make_deterministic()

    def make(name, seed=7, seconds=0.2):
        return harness.Context(name, small(name), seed, seconds, False,
                               torch.device("cpu"), time.perf_counter())

    return make
