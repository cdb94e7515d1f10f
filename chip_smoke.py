#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and nothing is swallowed:

1. Build every CUDA kernel of the serving path (``nvcc``, all sources
   at once) into ``build/kernels/``.
2. Run the VoteNet forward once (B=8, N=40000, height feature, random
   seeded weights) on a synthetic batch to obtain the inputs each kernel
   gets on the main path, then hold each kernel against its plain
   PyTorch version on the card at those inputs: FPS bit-exact (plus a
   padded tail, an all-padding row and ``candidates=8192``), stratified
   ball query exact except at points within rounding error of the
   radius. Kernel and plain times are medians of CUDA events.
3. Reset the launch counters, run the port's evaluation entry point
   (``backtoreality_tpu_torch.train.evaluate.main``) over 16 synthetic
   scans at B=8, N=40000 on ``cuda``, check that each kernel was
   launched 5 times per batch and that the mAP numbers are finite, time
   the forward per batch, and print its device time by kernel
   (``torch.profiler``).
4. Print the card's name and power limit, one JSON line with every
   kernel's numbers, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It exits nonzero without a CUDA device, and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
B, N = 8, 40000
NUM_SCANS = 16
# published H100 SXM peaks: f32 outside the
# tensor cores, and HBM bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
FPS_OPS_PER_POINT = 10  # 3 sub, 3 mul, 2 add, 1 min, 1 compare
BQ_OPS_PER_TEST = 9  # 3 sub, 3 mul, 2 add, 1 compare
# the plain ball query's expanded form |c|^2 - 2c.p + |p|^2 rounds to a
# few ulps of (|c| + |p|)^2; a kernel/plain disagreement is allowed only
# for a point this close to the radius (about 1e-5 at room scale)
BQ_GAP_ULPS = 8 * 2.0 ** -24


def require(cond, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_header() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of `fn` over `reps` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_fps(label, xyz, npoint, fps, reps, candidates=None):
    """Kernel vs plain FPS on one input; returns the per-shape record."""
    import torch

    got = fps.furthest_point_sample(xyz, npoint, candidates=candidates)
    x = xyz[:, :candidates] if candidates else xyz
    want = fps._fps_torch(x, npoint)
    torch.cuda.synchronize()
    require(torch.equal(got, want),
            f"fps {label}: kernel != plain at"
            f" {(got != want).sum().item()} of {got.numel()} samples")
    b, n, _ = x.shape
    ms = cuda_ms(lambda: fps._fps_cuda(x, npoint), reps)
    plain = cuda_ms(lambda: fps._fps_torch(x, npoint), 2)
    bnd, by = bound_ms(FPS_OPS_PER_POINT * b * (npoint - 1) * n,
                       b * n * 12 + b * npoint * 4)
    print(f"  fps {label:14s} B={b} N={n} -> {npoint}: kernel {ms:.4f} ms,"
          f" plain {plain:.3f} ms, bound {bnd:.4f} ms ({by}),"
          f" bit-exact")
    return dict(shape=label, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, max_abs_err=0)


def bq_gaps(xyz, ctr, radius, ki, kh, pi, ph):
    """|d^2 - r^2| (f64, direct form) and the tolerance at every point
    where the kernel and the plain version disagree, plus the number of
    centres whose slots differ with no such point behind them."""
    import torch

    n = xyz.shape[1]
    slot_diff = (kh != ph) | (kh & ph & (ki != pi))
    # the disputed point is the earlier of the two first hits
    first_k = torch.where(kh, ki, n)
    first_p = torch.where(ph, pi, n)
    j = torch.minimum(first_k, first_p)[slot_diff].long()
    bi, mi, _ = slot_diff.nonzero(as_tuple=True)
    p = xyz[bi, j].double()
    c = ctr[bi, mi].double()
    gap = (((p - c) ** 2).sum(-1) - radius * radius).abs()
    tol = BQ_GAP_ULPS * (p.norm(dim=-1) + c.norm(dim=-1)) ** 2
    fill_only = (~kh & ~ph & (ki != pi)).any(-1) & ~slot_diff.any(-1)
    return gap, tol, int(fill_only.sum())


def check_bq(label, xyz, ctr, radius, nsample, bq, reps):
    import torch

    ki, kh = bq.ball_query_stratified(xyz, ctr, radius, nsample,
                                      return_hit=True)
    pi, ph = bq._ball_query_stratified_torch(xyz, ctr, radius, nsample)
    torch.cuda.synchronize()
    gap, tol, orphans = bq_gaps(xyz, ctr, radius, ki, kh, pi, ph)
    max_gap = gap.max().item() if gap.numel() else 0.0
    require(orphans == 0, f"bq {label}: {orphans} centres differ in"
                          " slot-fill alone")
    require(bool((gap <= tol).all()),
            f"bq {label}: disagreement {max_gap:.3e} from the radius,"
            f" above the tolerance")
    b, n, _ = xyz.shape
    m = ctr.shape[1]
    bucket = bq._bucket_size(n, nsample)
    # work this data needs: each slot scans up to its bucket's first hit
    base = torch.arange(nsample, device=xyz.device) * bucket
    span = torch.clamp(n - base, 0, bucket)
    tests = torch.where(ph, pi - base + 1, span).sum().item()
    ms = cuda_ms(lambda: bq._ball_query_stratified_cuda(
        xyz, ctr, radius, nsample), reps)
    plain = cuda_ms(lambda: bq._ball_query_stratified_torch(
        xyz, ctr, radius, nsample), 3)
    bnd, by = bound_ms(BQ_OPS_PER_TEST * tests,
                       b * n * 12 + b * m * 12 + b * m * nsample * 5)
    print(f"  bq  {label:14s} N={n} M={m} S={nsample} r={radius}"
          f" bucket={bucket}: kernel {ms:.4f} ms, plain {plain:.3f} ms,"
          f" bound {bnd:.4f} ms ({by}), {tests} distance tests,"
          f" hit rate {ph.float().mean().item():.3f},"
          f" {gap.numel()} boundary disagreements (max |d2-r2|"
          f" {max_gap:.2e})")
    return dict(shape=label, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, max_abs_err=max_gap,
                boundary_points=gap.numel())


def summarize(name, kernel, source, records, launches):
    """One kernel's line: times summed over the main-path shapes, so
    `ms` is that kernel's time per forward."""
    main = [r for r in records if r.get("main_path")]
    ops_bound = sum(r["bound_ms"] for r in main if r["bound_by"] ==
                    "operations")
    byte_bound = sum(r["bound_ms"] for r in main if r["bound_by"] ==
                     "bytes")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": kernel.replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": ops_bound + byte_bound,
        "bound_by": "operations" if ops_bound >= byte_bound else "bytes",
        "library_ms": None,
        "per_shape": records,
    }


def profile_forward(model, pc):
    """Device time by kernel over 3 forwards (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model(pc)
        torch.cuda.synchronize()
    print("[profile] 3 forwards, by self device time")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
    from backtoreality_tpu_torch.ops import _build
    from backtoreality_tpu_torch.ops import ball_query as bq
    from backtoreality_tpu_torch.ops import fps
    from backtoreality_tpu_torch.train import evaluate

    header = card_header()
    print(f"card: {header}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}"
          f" python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all([fps.KERNEL, bq.KERNEL])
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # fixture and seeded checkpoint
    tmp = tempfile.TemporaryDirectory()
    scans = pathlib.Path(tmp.name) / "scans"
    cfg = get_config("scannet_md40")
    # ~44k points a scan, so the 40k-point draw needs no repeats
    write_synthetic_scans(scans, cfg, num_scans=NUM_SCANS, seed=0,
                          points_per_object=4500, floor_points=8000)
    common = ["--data_root", str(scans), "--split", "all",
              "--num_point", str(N), "--batch_size", str(B)]
    flags = evaluate.add_common_flags(argparse.ArgumentParser()).parse_args(
        [])  # the CLI defaults: height feature, 256 proposals, vote_fps
    torch.manual_seed(0)
    model = evaluate.build_model(flags, cfg)
    ckpt = pathlib.Path(tmp.name) / "votenet.pt"
    torch.save(model.state_dict(), ckpt)
    model.to(device).eval()
    ds = DetectionDataset(cfg, scans, split="all", num_points=N,
                          use_height=True)
    batch = next(iter(DetectionDataLoader(ds, B, shuffle=False,
                                          prefetch=0)))
    pc = torch.from_numpy(batch["point_clouds"]).to(device)
    with torch.inference_mode():
        ep = model(pc)
    torch.cuda.synchronize()

    # 2. kernels against their plain versions at the main path's inputs
    print("[kernels] kernel vs plain on the card (median of CUDA events)")
    xyz = pc[..., 0:3]
    fps_records = []
    for label, x, npoint in (
            ("sa1", xyz, 2048), ("sa2", ep["sa1_xyz"], 1024),
            ("sa3", ep["sa2_xyz"], 512), ("sa4", ep["sa3_xyz"], 256),
            ("vote_agg", ep["vote_xyz"], 256)):
        rec = check_fps(label, x, npoint, fps, reps=5)
        rec["main_path"] = True
        fps_records.append(rec)
    edge = xyz.clone()
    edge[0, N - N // 10:] = 0.0  # padded tail
    edge[1] = 0.0  # all padding
    fps_records.append(check_fps("padded", edge, 2048, fps, reps=1))
    require(bool((fps.furthest_point_sample(edge, 64)[1] == 0).all()),
            "fps: an all-padding row must give index 0")
    fps_records.append(check_fps("candidates8192", xyz, 2048, fps, reps=3,
                                 candidates=8192))
    odd = torch.randn(3, 257, 3, device=device,
                      generator=torch.Generator(device).manual_seed(0))
    fps_records.append(check_fps("n257", odd, 33, fps, reps=3))

    bq_records = []
    for label, x, c, r, s in (
            ("sa1", xyz, ep["sa1_xyz"], 0.2, 64),
            ("sa2", ep["sa1_xyz"], ep["sa2_xyz"], 0.4, 32),
            ("sa3", ep["sa2_xyz"], ep["sa3_xyz"], 0.8, 16),
            ("sa4", ep["sa3_xyz"], ep["sa4_xyz"], 1.2, 16),
            ("vote_agg", ep["vote_xyz"], ep["aggregated_vote_xyz"], 0.3,
             16)):
        rec = check_bq(label, x, c, r, s, bq, reps=10)
        rec["main_path"] = True
        bq_records.append(rec)
    del ep

    # 3. the main path: the evaluation entry point on the card
    for k in (fps.KERNEL, bq.KERNEL):
        k.launches = 0
    t0 = time.perf_counter()
    results = evaluate.main(["--model", "votenet", "--checkpoint_path",
                             str(ckpt), "--device", "cuda", *common])
    eval_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in (fps.KERNEL, bq.KERNEL)}
    batches = math.ceil(NUM_SCANS / B)
    print(f"[main path] evaluate.main over {NUM_SCANS} scans in"
          f" {eval_s:.1f} s; launches {launches} over {batches} batches")
    for name, count in launches.items():
        require(count == 5 * batches,
                f"{name}: {count} launches, expected 5 per batch")
    for (_, t), metrics in results.items():
        require(math.isfinite(metrics["mAP"]) and
                math.isfinite(metrics["AR"]), f"non-finite mAP @ {t}")
        print(f"  mAP@{t} {metrics['mAP']:.4f}  AR@{t} {metrics['AR']:.4f}")

    model.load_state_dict(torch.load(ckpt, map_location=device,
                                     weights_only=True))
    with torch.inference_mode():
        out = model(pc)
        require(out["center"].shape == (B, 256, 3) and
                bool(torch.isfinite(out["center"]).all()),
                "forward output not finite or of the wrong shape")
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = cuda_ms(lambda: model(pc), reps=10, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"[forward] VoteNet B={B} N={N}: {fwd_ms:.3f} ms per batch"
          f" (median of 10), {B / fwd_ms * 1e3:.1f} scenes/s,"
          f" peak {peak_gb:.2f} GiB  | {header}")

    kernels = [
        summarize("fps", fps.KERNEL, "backtoreality_tpu_torch/csrc/fps.cu",
                  fps_records, launches["fps"]),
        summarize("ball_query_stratified", bq.KERNEL,
                  "backtoreality_tpu_torch/csrc/ball_query.cu", bq_records,
                  launches["ball_query"]),
    ]
    profile_forward(model, pc)
    tmp.cleanup()
    print(header)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
