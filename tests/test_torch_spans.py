"""The port's spans (`train/observability.span`): the shared no-op off the
profiler, the names and nesting of PERF.md §3 in one VoteNet and one
GroupFree3D update under ``torch.profiler`` at a tiny size, the hand
kernels' launch spans through stub libraries, and `TraceWindow`'s trace
holding them. CPU only; imports nothing of JAX."""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from backtoreality_tpu_torch.data import get_config
from backtoreality_tpu_torch.data.dataset import DetectionDataset
from backtoreality_tpu_torch.data.loader import DetectionDataLoader
from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
from backtoreality_tpu_torch.losses import groupfree as gf_losses
from backtoreality_tpu_torch.losses import votenet as vote_losses
from backtoreality_tpu_torch.ops import _build
from backtoreality_tpu_torch.train import (common, evaluate, groupfree,
                                           observability, votenet)

B, N = 2, 2048
# the modules (the package exports a function under ball_query's name)
fps, ball_query, grouping = (
    importlib.import_module(f"backtoreality_tpu_torch.ops.{m}")
    for m in ("fps", "ball_query", "grouping"))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """One batch of two synthetic scans with VoteNet's labels and one with
    GroupFree3D's, as tensors."""
    cfg = get_config("scannet_md40")
    root = tmp_path_factory.mktemp("torch_spans")
    write_synthetic_scans(root, cfg, num_scans=B, num_objects=3,
                          points_per_object=300, floor_points=800, seed=0)
    out = {}
    for name, kw in (("votenet", dict(use_height=True)),
                     ("groupfree", dict(use_height=False, gf_labels=True))):
        ds = DetectionDataset(cfg, root, split="all", num_points=N,
                              use_color=False, augment=False, seed=0, **kw)
        loader = DetectionDataLoader(ds, B, shuffle=False, num_workers=1)
        batch = next(iter(loader))
        out[name] = common.to_device(batch, "cpu")
    return cfg, out


def _export(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return path


def _ranges(path) -> list:
    """The program's ranges in a Chrome trace (user ranges but
    ``torch.optim``'s ``Optimizer.*``): [(name, tid, start, end)]."""
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and not e["name"].startswith("Optimizer.")]


def _parents(ranges) -> dict:
    """Each range's name -> the set of names of the innermost range that
    holds it on its thread (None at the top)."""
    out = collections.defaultdict(set)
    for name, tid, s, e in ranges:
        holders = [r for r in ranges if r[1] == tid and r[2] <= s
                   and e <= r[3] and r != (name, tid, s, e)]
        inner = max(holders, key=lambda r: (r[2], -r[3]), default=None)
        out[name].add(None if inner is None else inner[0])
    return out


def test_span_off_the_profiler_is_one_shared_no_op(tmp_path):
    assert observability.span("step") is observability.span("model")
    assert isinstance(observability.span("step"), contextlib.nullcontext)
    with observability.span("step"):
        pass

    @observability.spanned("loss")
    def f(x):
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2)
    assert _ranges(_export(prof, tmp_path)) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = observability.span("step")
        with on:
            assert f(1) == 2
    assert on is not observability.span("step")
    names = sorted(r[0] for r in _ranges(_export(prof, tmp_path)))
    assert names == ["loss", "step"]


def _votenet_step(cfg):
    flags = votenet.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--num_point", str(N), "--num_target", "64"])
    torch.manual_seed(0)
    model = evaluate.build_model(flags, cfg, "plain")
    opt = common.make_optimizer(model.parameters(), "adam", 0.0, lr0=1e-3)
    return votenet.make_train_step(model, opt, vote_losses.get_loss, cfg)


def _gf_step(cfg, layers=2):
    flags = groupfree.add_flags(argparse.ArgumentParser()).parse_args(
        ["--num_point", str(N), "--num_target", "64",
         "--num_decoder_layers", str(layers)])
    torch.manual_seed(0)
    model = groupfree.build_model(flags, cfg, "plain")
    opt = common.make_gf_optimizer(model, lambda c: 1e-3, lambda c: 1e-4,
                                   5e-4, 0.1)
    return groupfree.make_train_step(model, opt, gf_losses.get_loss, cfg,
                                     groupfree.loss_kwargs(flags))


BACKBONE = ("model.backbone.sa1", "model.backbone.sa2", "model.backbone.sa3",
            "model.backbone.sa4", "model.backbone.fp1", "model.backbone.fp2")
LOSS_TERMS = ("loss.vote", "loss.objectness", "loss.box_sem")


def _check_common(parents, counts):
    assert parents["step"] == {None}
    assert parents["model"] == {"step"}
    assert parents["loss"] == {"step"}
    assert parents["step.backward"] == {"step"}
    assert parents["step.optimizer"] == {"step"}
    assert parents["model.backbone"] == {"model"}
    for name in BACKBONE:
        assert parents[name] == {"model.backbone"}, name
        assert counts[name] == 1
    assert counts["step"] == counts["model"] == counts["loss"] == 1


def test_votenet_update_spans_in_the_trace_window(batches, tmp_path):
    """One VoteNet update traced by `TraceWindow` (``--profile_dir``):
    its trace file holds the spans, nested as PERF.md §3 has them."""
    cfg, batch = batches
    step = _votenet_step(cfg)
    window = observability.TraceWindow(tmp_path / "trace", first=1, last=1)
    window.before(1)
    step(batch["votenet"], 0.5)
    window.after(1)
    ranges = _ranges(tmp_path / "trace" / "trace_rank0.json")
    parents = _parents(ranges)
    counts = collections.Counter(r[0] for r in ranges)
    _check_common(parents, counts)
    assert parents["model.voting"] == parents["model.proposal"] == {"model"}
    for name in LOSS_TERMS:
        assert parents[name] == {"loss"} and counts[name] == 1, name
    # the plain versions run on the CPU: no launch spans
    assert set(counts) == {"step", "model", "model.backbone", *BACKBONE,
                           "model.voting", "model.proposal", "loss",
                           *LOSS_TERMS, "step.backward", "step.optimizer"}


def test_groupfree_update_spans(batches, tmp_path):
    cfg, batch = batches
    step = _gf_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch["groupfree"], 0.1)
    ranges = _ranges(_export(prof, tmp_path))
    parents = _parents(ranges)
    counts = collections.Counter(r[0] for r in ranges)
    _check_common(parents, counts)
    layers = ("model.decoder.layer0", "model.decoder.layer1")
    for name in ("model.kps", "model.proposal", "model.decoder"):
        assert parents[name] == {"model"} and counts[name] == 1, name
    for name in layers:
        assert parents[name] == {"model.decoder"} and counts[name] == 1
    # one span a term, whatever the number of heads it sums over
    for name in ("loss.kps", "loss.objectness", "loss.box_sem"):
        assert parents[name] == {"loss"} and counts[name] == 1, name
    assert set(counts) == {"step", "model", "model.backbone", *BACKBONE,
                           "model.kps", "model.proposal", "model.decoder",
                           *layers, "loss", "loss.kps", "loss.objectness",
                           "loss.box_sem", "step.backward",
                           "step.optimizer"}


class _Stub:
    """A kernel library whose launchers do nothing and succeed."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_kernel_launch_spans(monkeypatch, tmp_path):
    """The host side of each launch through the ctypes libraries, on CPU
    tensors with stub libraries (the outputs are not read): FPS, the
    stratified and the exact query, the grouping's forward and its
    backward, which autograd runs with the forward's spans closed."""
    for kernel in (fps.KERNEL, ball_query.KERNEL, grouping.KERNEL):
        monkeypatch.setattr(kernel, "_lib", _Stub())
    for counter in (fps.KERNEL, ball_query.KERNEL, ball_query.EXACT,
                    grouping.KERNEL, grouping.LOCALIZE):
        for name in ("launches", "backward_launches", "bytes"):
            monkeypatch.setattr(counter, name, getattr(counter, name))
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(1, 256, 3, generator=g)
    centres = xyz[:, :32].clone().requires_grad_()
    feats = torch.rand(1, 256, 4, generator=g, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fps._fps_cuda(xyz, 32)
        ball_query._ball_query_exact_cuda(xyz, centres.detach(), 0.3, 8)
        idx, hit = ball_query._ball_query_stratified_cuda(
            xyz, centres.detach(), 0.3, 8)
        idx.zero_()
        out = grouping._GroupLocalizeCuda.apply(
            xyz.requires_grad_(), feats, centres, idx, hit, 0.3)
        out.sum().backward()
    counts = collections.Counter(
        r[0] for r in _ranges(_export(prof, tmp_path)))
    assert counts == {"kernel.fps": 1, "kernel.ball_query": 2,
                      "kernel.group": 1, "kernel.group.backward": 1}
