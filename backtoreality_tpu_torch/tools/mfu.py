"""Roofline accounting of a train step: FLOPs and bytes against the card's
peaks.

Counterpart of ``backtoreality_tpu/tools/mfu.py``: how much of the
card's arithmetic and memory rate one whole train step (forward, loss,
backward, optimizer) uses, at the configurations the JAX tool measures.

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one step, the
  model FLOPs of the usual MFU convention: matrix products, convolutions
  and attention. The hand kernels (FPS, the ball query, the grouping)
  and the elementwise passes are not counted; ``counted`` in the output
  says so. XLA's ``cost_analysis()`` in the JAX tool counts every fused
  op, so the two counts are not held equal.
- Bytes: a ``TorchDispatchMode`` sums the bytes of every aten op's
  inputs and outputs (views and allocations move nothing and are not
  counted), plus each hand kernel's own input and output bytes, which its
  wrapper adds where it launches (``Kernel.bytes``): the dispatcher never
  sees a ctypes launch. The count is logical and unfused, an upper
  estimate of the memory traffic, as the JAX tool's "bytes accessed".
  On the CPU the kernels' plain versions run; their calls are counted as
  their inputs and outputs too, and the grouping's plain backward as the
  aten ops it runs.
- Time: the wall of ``iters`` steps closed by a synchronise, after a
  warm-up step.
- Peaks: NVIDIA's published dense figures by ``torch.cuda.
  get_device_name()``, not measured here. f32 is the CUDA cores' rate:
  the port computes in f32 with TF32 off.

Usage:  python -m backtoreality_tpu_torch.tools.mfu [--model gf|both]
            [--iters 30] [--fps_candidates 8192] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import time
import types

import numpy as np
import torch

# kind-substring: (bf16 dense tensor-core peak, f32 CUDA-core peak) in
# TFLOP/s, the more specific substring first. NVIDIA's H100 datasheet:
# SXM5 ("NVIDIA H100 80GB HBM3", 700 W) and PCIe.
PEAKS_TFLOPS = {
    "h100 pcie": (756.0, 51.2),
    "h100 80gb hbm3": (989.4, 66.9),
    "h100 sxm": (989.4, 66.9),
    "cpu": (0.1, 0.05),  # placeholder so the tool runs hermetically
}

# memory bandwidth GB/s by kind-substring (the same datasheet)
PEAKS_HBM_GBS = {
    "h100 pcie": 2000.0,
    "h100 80gb hbm3": 3350.0,
    "h100 sxm": 3350.0,
    "cpu": 50.0,  # placeholder so the tool runs hermetically
}

# the ops whose CUDA launches the dispatcher never sees: their calls are
# opaque to the counting modes and counted by their own bytes
KERNEL_OPS = ("furthest_point_sample", "ball_query_stratified",
              "ball_query", "group_localize_stratified",
              "group_points_stratified")

# aten ops that move no data: allocations (views are told by `is_view`)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias"}

COUNTED = ("FLOPs: matrix products, convolutions and attention"
           " (FlopCounterMode); not the hand kernels (FPS, ball query,"
           " grouping) nor elementwise passes. Bytes: every aten op's"
           " inputs and outputs, unfused, views and allocations excluded,"
           " plus each hand kernel's inputs and outputs")


def _peaks(kind: str):
    k = kind.lower()
    for sub, peaks in PEAKS_TFLOPS.items():
        if sub in k:
            return peaks
    return (None, None)


def _hbm_peak(kind: str):
    k = kind.lower()
    for sub, peak in PEAKS_HBM_GBS.items():
        if sub in k:
            return peak
    return None


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCount(torch.utils._python_dispatch.TorchDispatchMode):
    """``bytes``: the input and output bytes of every aten op run inside,
    views and allocations excluded."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket.__name__ not in \
                _NO_TRAFFIC:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


@contextlib.contextmanager
def kernels_opaque(counts: ByteCount):
    """Within, the hand kernels' entries (`KERNEL_OPS`, as the nn modules
    reach them in ``backtoreality_tpu_torch.ops``) run with the counting
    modes off: their launches are not aten ops. A call on the CPU (the
    plain version) adds its inputs' and outputs' bytes to `counts`; a
    launch adds them to its kernel's ``bytes`` itself."""
    from backtoreality_tpu_torch import ops
    from torch.utils._python_dispatch import _disable_current_modes

    def opaque(fn):
        def call(*args, **kwargs):
            with _disable_current_modes():
                out = fn(*args, **kwargs)
            if not any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in args):
                counts.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            return out
        return call

    saved = {name: getattr(ops, name) for name in KERNEL_OPS}
    for name, fn in saved.items():
        setattr(ops, name, opaque(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _kernels():
    """The three kernels and the exact query's entry, which counts its
    own bytes (the package exports functions under the modules'
    names)."""
    modules = {name: importlib.import_module(
        f"backtoreality_tpu_torch.ops.{name}")
        for name in ("fps", "ball_query", "grouping")}
    return tuple(m.KERNEL for m in modules.values()) + (
        modules["ball_query"].EXACT,)


def count_step(step_fn):
    """(FLOPs, bytes) of one call of `step_fn`."""
    from torch.utils.flop_counter import FlopCounterMode

    kernels = _kernels()
    before = sum(k.bytes for k in kernels)
    counts = ByteCount()
    with kernels_opaque(counts), FlopCounterMode(display=False) as flops, \
            counts:
        step_fn()
    launched = sum(k.bytes for k in kernels) - before
    return flops.get_total_flops(), counts.bytes + launched


def _flags(num_target=64, fps_candidates=None):
    """The JAX tool's VoteNet flags (``__graft_entry__._flags``): no
    height feature, vote FPS, stratified query, f32."""
    return types.SimpleNamespace(
        no_height=True, use_color=False, vote_factor=1,
        cluster_sampling="vote_fps", query_mode="stratified",
        num_target=num_target, fps_candidates=fps_candidates, bf16=False,
        f32_tail=0)


def _example_batch(cfg, b, n, rng):
    """The JAX tool's VoteNet batch (``__graft_entry__._example_batch``)."""
    k = cfg.max_num_obj
    return {
        "point_clouds": rng.random((b, n, 3), dtype=np.float32) * 4 - 2,
        "center_label": rng.random((b, k, 3), dtype=np.float32) * 4 - 2,
        "box_label_mask": (np.arange(k) < 5).astype(np.float32)[None]
        .repeat(b, 0),
        "sem_cls_label": np.zeros((b, k), np.int32),
        "heading_class_label": np.zeros((b, k), np.int32),
        "heading_residual_label": np.zeros((b, k), np.float32),
        "size_class_label": np.zeros((b, k), np.int32),
        "size_residual_label": np.zeros((b, k, 3), np.float32),
        "vote_label": np.zeros((b, n, 9), np.float32),
        "vote_label_mask": np.ones((b, n), np.int32),
        "center_jitter": np.zeros((b, k, 3), np.float32),
    }


def _gf_flags():
    """The JAX tool's GroupFree3D flags (``__graft_entry__._gf_flags``,
    the reference defaults), at its dryrun's small decoder; `measure`
    sets the measured widths."""
    return types.SimpleNamespace(
        no_height=True, use_height=False, use_color=False, width=1,
        num_target=16, sampling="kps", nhead=8, num_decoder_layers=1,
        dim_feedforward=64, transformer_dropout=0.1,
        self_position_embedding="loc_learned",
        cross_position_embedding="xyz_learned", query_mode="stratified",
        fps_candidates=None, bf16=False, f32_tail=0,
        query_points_generator_loss_coef=0.8, obj_loss_coef=0.1,
        box_loss_coef=1.0, sem_cls_loss_coef=0.1,
        center_loss_type="smoothl1", center_delta=1.0,
        size_loss_type="smoothl1", size_delta=1.0,
        heading_loss_type="smoothl1", heading_delta=1.0,
        query_points_obj_topk=4)


def _gf_example_batch(cfg, b, n, rng):
    """GF batch = VoteNet labels + KPS supervision
    (``__graft_entry__._gf_example_batch``)."""
    batch = _example_batch(cfg, b, n, rng)
    batch["point_obj_mask"] = (rng.random((b, n)) > 0.5).astype(np.int32)
    batch["point_instance_label"] = rng.integers(
        -1, 5, (b, n)).astype(np.int32)
    batch["size_gts"] = cfg.mean_size_arr[
        batch["size_class_label"]].astype(np.float32)
    return batch


def build_step(model_name: str, fps_candidates: int | None, device,
               batch_size: int, num_points: int):
    """(step, batch, bn_momentum): the JAX tool's configuration of
    `model_name` on `device`, weights seeded with 0."""
    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.train import common

    cfg = get_config("scannet_md40")
    rng_np = np.random.default_rng(0)
    torch.manual_seed(0)
    if model_name == "votenet":
        from backtoreality_tpu_torch.losses import votenet as vote_losses
        from backtoreality_tpu_torch.train import votenet

        model = votenet.build_model(
            _flags(num_target=256, fps_candidates=fps_candidates),
            cfg).to(device)
        optimizer = common.make_optimizer(model.parameters(), "adam",
                                          lr0=1e-3)
        batch = _example_batch(cfg, batch_size, num_points, rng_np)
        step = votenet.make_train_step(model, optimizer,
                                       vote_losses.get_loss, cfg)
        bn_momentum = 0.5
    elif model_name == "gf":
        from backtoreality_tpu_torch.losses import groupfree as gf_losses
        from backtoreality_tpu_torch.train import groupfree as gf

        flags = _gf_flags()
        flags.num_target = 256
        flags.num_decoder_layers = 6
        flags.dim_feedforward = 2048
        flags.fps_candidates = fps_candidates
        model = gf.build_model(flags, cfg).to(device)
        optimizer = common.make_gf_optimizer(model, lambda count: 4e-3,
                                             lambda count: 4e-4, 5e-4, 0.1)
        batch = _gf_example_batch(cfg, batch_size, num_points, rng_np)
        step = gf.make_train_step(model, optimizer, gf_losses.get_loss, cfg,
                                  gf.loss_kwargs(flags))
        bn_momentum = 0.1
    else:
        raise ValueError(f"unknown model {model_name!r}")
    return step, common.to_device(batch, device), bn_momentum


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(model_name: str, iters: int = 30,
            fps_candidates: int | None = 8192, *, device=None,
            batch_size: int | None = None,
            num_points: int | None = None) -> dict:
    """One JSON line (printed and returned) for `model_name` (votenet:
    B=8, N=40000, Adam at 1e-3, BN momentum 0.5; gf: B=8, N=50000, 6
    decoder layers, feed-forward 2048, AdamW in two groups, clip 0.1, BN
    momentum 0.1). `device` defaults to the card."""
    from backtoreality_tpu_torch.train import common

    device = common.resolve_device(device)
    default_b, default_n = (8, 40000) if model_name == "votenet" else (
        8, 50000)
    b = batch_size or default_b
    n = num_points or default_n
    step, batch, bnm = build_step(model_name, fps_candidates, device, b, n)

    flops, nbytes = count_step(lambda: step(batch, bnm))
    # warm-up, then the wall of `iters` steps closed by a synchronise
    step(batch, bnm)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        aux = step(batch, bnm)
    loss = float(aux["loss"])
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    if not math.isfinite(loss):
        raise FloatingPointError(f"{model_name}: loss {loss}")

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    peak_bf16, peak_f32 = _peaks(kind)
    hbm_peak = _hbm_peak(kind)
    achieved = flops / dt / 1e12
    achieved_gbs = nbytes / dt / 1e9
    out = {
        "model": model_name,
        "device_kind": kind,
        "batch": b,
        "num_points": n,
        "fps_candidates": fps_candidates,
        "iters": iters,
        "step_ms": dt * 1e3,
        "flops_per_step": flops,
        "achieved_tflops": achieved,
        "bytes_per_step": nbytes,
        "achieved_gbs": achieved_gbs,
        "counted": COUNTED,
    }
    if peak_f32:
        out["pct_of_f32_peak"] = 100 * achieved / peak_f32
        out["pct_of_bf16_peak"] = 100 * achieved / peak_bf16
    if hbm_peak:
        out["pct_of_hbm_peak"] = 100 * achieved_gbs / hbm_peak
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="votenet",
                        choices=["votenet", "gf", "both"])
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--fps_candidates", type=int, default=8192,
                        help="subset-FPS candidate count; 0 = exact "
                        "full-cloud FPS")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; pass cpu to run"
                             " on the CPU)")
    args = parser.parse_args(argv)
    from backtoreality_tpu_torch.train import common

    # as every entry point: the steps measured are the ones users run
    common.make_deterministic()
    models = (["votenet", "gf"] if args.model == "both"
              else [args.model])
    return [measure(m, args.iters, args.fps_candidates or None,
                    device=args.device) for m in models]


if __name__ == "__main__":
    main()
