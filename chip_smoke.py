#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and nothing is swallowed.
The determinism switch (``train.common.make_deterministic``) is on from
the start, as every entry point turns it on: every train step below is
gated on two steps from one state giving bitwise-equal parameters.

1. Build every CUDA kernel (``nvcc``, one process per source, all started
   together) into ``build/kernels/``.
2. Run the VoteNet forward once (B=8, N=40000, height feature, random
   seeded weights) on a synthetic batch to obtain the inputs each kernel
   gets on the main paths, then hold each kernel against its plain
   PyTorch version on the card at those inputs: FPS bit-exact, in the
   layout the wrapper picks and in every other one (cluster size,
   threads, points a thread), plus off the paths a padded tail, an
   all-padding row, one scan alone, 50000 points, duplicated points whose
   ties fall across blocks, lanes and registers, shards of padding only,
   and a row that takes the capacity kernel; stratified ball query exact
   except at points within rounding error of the radius, in every tile
   its plan may pick (both mappings, timed, with the tests executed
   beside the tests the data needs), plus off the paths M = 33 and 257, N
   below one bucket and no multiple of it, 1, 16 and 64 slots, a centre
   with no hit and one whose only hit is the last point, duplicated
   points, B = 1 and a strided xyz; stratified grouping forward bit-exact
   and its backward within 1e-5 (relative to the largest gradient) of the
   plain backward in float64 and bitwise equal over two runs, its three
   passes timed apart; the grouping fused with the localize step the same
   way (forward bit-exact with and without features; gradients of xyz,
   features and centres). Then the same at GroupFree3D's new shape, SA1
   on N=50000 rows (B=8, FPS over the full cloud, its CLI defaults), with
   the centres its forward draws: FPS in every layout, the ball query in
   every tile, the grouping unfused and fused for C = 3 and 3 + 1; and
   the jitter head of its CenterRefine graph at the fixture's GT centres
   (64 a scene, most padded at +1000 and hitting no point) over the sa2
   points and the 288-wide fp2 features: the ball query in every tile, the
   fused grouping at C = 3 + 288 divided by r = 0.8, its backward timed,
   with the length of its longest list. The data-parallel paths' shapes
   too: every call of VoteNet's training forward and GroupFree3D's SA1 on
   the first 4 of the 8 rows (a rank's share), each record tagged with
   those paths; every kernel must have such a record. Every wrapper
   raises on bfloat16 and float16 inputs without launching.
   Kernel, plain and library times are medians of CUDA events, with the
   host's launches queued ahead of the device so that they time device
   work; the plain and library backwards of the grouping run under the
   switch, PyTorch's deterministic (sorted) scatter-add.
3. Serving path: reset the launch counters, run the evaluation entry
   point (``backtoreality_tpu_torch.train.evaluate.main``) over 16
   synthetic scans at B=8, N=40000 on ``cuda``, check that FPS, ball
   query and the fused grouping each launched 5 times per batch and that
   the mAP numbers are finite, time the forward per batch, and print its
   device time by kernel (``torch.profiler``).
4. Training path: reset the counters, run the FSB entry point
   (``backtoreality_tpu_torch.train.votenet_fsb.main``) for 2 epochs
   over the 16 scans at B=8, N=40000, ``--fps_candidates 8192`` (4 steps
   and one evaluation); check finite losses, the launch counts (5 per
   forward for FPS, ball query and the fused grouping; 4 grouping
   backwards per step) and that ``evaluate.main`` loads the checkpoint.
   Then time the train step at ``bench.py``'s configuration (a fixed
   batch, Adam at lr 1e-3, BN momentum 0.5), print its device time by
   kernel and what the determinism switch costs it (wall and kernels with
   the switch off, on, and on with its NaN fill of new tensors; the three
   ops that grew most; the later steps without the fill's arm), and gate
   the FSB and the WSB step on bitwise repeatability.
5. The paper's recipes: the WSB, BR and BR+CenterRefine entry points
   (``votenet_{wsb,br,br_center_refine}.main``) for one epoch (2 steps)
   and one evaluation each at the same width, BR and CenterRefine with a
   virtual-scene source fixture, CenterRefine grafted from BR's
   checkpoint; the launch counts checked per recipe, and the CenterRefine
   checkpoint scored through ``evaluate --kind da_jitter``. Then the BR
   and CenterRefine train steps on one fixed pair of batches: wall time,
   phases, kernels' device time, peak memory, the switch's cost,
   bitwise repeatability. Then VoteNet with ``--bf16 --f32_tail 2``: the
   FSB step beside the float32 one (wall, kernels, busy, peak; gated on
   repeatability), the kernels held against their plain versions at that
   path's inputs (float32, the bfloat16 features promoted), and
   ``votenet_fsb.main --bf16 --f32_tail 2`` for one epoch of 2 steps and
   an evaluation, which recalibrates BN over 20 train batches first (the
   float32 path's launches a forward and backwards a step).
6. The checkpoint gates: the JAX package's trained checkpoint
   (``evidence/round4/ckpt/lad_f32.tar.gz``) read by the port's msgpack
   reader and scored by ``evaluate.main`` over 3 subsample seeds on the
   100-scan shapefix val; fails unless each IoU's mean mAP lies within
   the JAX package's spread of its mean. Then its bfloat16 checkpoint
   ``lad_t2`` through ``evaluate --bf16 --f32_tail 2`` after 20 batches
   of BN recalibration on the shapefix train split, as the JAX package
   scored it; fails unless each mean lies within twice the JAX spread.
7. GroupFree3D at its CLI defaults (B=8, N=50000, 6 decoder layers, 256
   queries, no height feature) on 16 synthetic scans of 52000 points:
   ``evaluate --model groupfree`` with random seeded weights (launches 4
   FPS, 4 ball queries, 4 fused groupings a batch; finite mAP; the
   forward's time, peak memory and device time by kernel); ``gf_fsb`` and
   ``gf_wsb`` for one epoch (2 steps) and one evaluation each (3 grouping
   backwards a step), the FSB checkpoint scored by ``evaluate --model
   groupfree``; the GF FSB train step on a fixed batch (wall, phases,
   kernels' device time, peak memory, the switch's cost; the FSB and WSB
   steps gated on bitwise repeatability); the same FSB step and
   ``gf_fsb.main`` with ``--bf16 --f32_tail 2`` (20 recalibration
   batches before the evaluation);
   ``gf_br`` and ``gf_br_center_refine`` for one epoch (2 steps of 8 + 8
   scenes) and one evaluation each, a 16-scan virtual fixture of 52000
   points a scan as the source (launches 4/4/4 a forward, 4/5/5 with the
   jitter head; 6 and 7 backwards a step), BR's checkpoint grafted into
   CenterRefine (the partial-restore counts checked) and scored by
   ``evaluate --model groupfree``; both DA steps on a fixed pair of
   batches (wall, phases, kernels' device time, busy share, peak memory,
   the switch's cost, bitwise repeatability gated). Then the learning
   check: ``gf_fsb`` on the shapefix train split at the JAX package's
   shapefix configuration (N=20000, height, subset FPS over 8192) for 50
   epochs of 5 steps, each epoch's loss beside the JAX run's
   (``evidence/round5/gflad/f32_metrics.jsonl``); fails unless the mean
   loss over epochs 40-49 lies within 0.67-1.5 times the JAX run's and
   mAP@0.25 at epoch 49 reaches 0.30.
8. ``--query_mode exact``, the reference's first-k query (plain PyTorch,
   ``ops.ball_query``): at the five VoteNet layers' shapes (B=8,
   N=40000) and GroupFree3D's SA1 (N=50000) on the card against the same
   call on the CPU, equal except at centres whose first differing slot
   holds a point within 1e-5 r^2 of the radius (counted), timed beside K3
   at the same shape, with its peak memory. The reference's initial
   checkpoints in the repo (``evidence/round5/{wsb,br,gf}/
   ref_init_checkpoint.tar.gz``) converted by the port's
   ``tools.torch_import`` CLI, each restored into its graph with no entry
   left fresh. ``evaluate --query_mode exact`` serving WSB's init
   (VoteNet, B=8, N=40000) and GF's (2 decoder layers, feed-forward 128,
   height, N=50000): FPS 5 and 4 launches a forward, K3 and K4 none; a
   batch timed. Then the round-5 system-parity pairs (WSB, BR,
   CenterRefine, GF) on the ``parity`` and ``br`` fixtures of the port's
   ``tools.parity_fixture``, each recipe's ``main`` with the JAX leg's
   flags (held to its ``ours_config.json``), WSB, BR and GF from the
   imported inits, CenterRefine from scratch, for 51, 30, 30 and 51
   epochs; ``tools.parity_report`` against the reference loop's history;
   fails unless the late ratio (the mean train loss over the last 11
   matched epochs over the reference's) lies within 0.85-1.15, printed
   beside the JAX leg's, with the mAP rows (not gated).
9. Data parallelism, the preemption guard and the profiler window.
   ``[data parallel]``: ``votenet_fsb.main --multihost`` as a group of one
   (``BTR_NUM_PROCESSES=1``, NCCL) bitwise the plain run (losses and final
   state, 2 steps); then two ranks spawned on the one card (gloo, the
   stated rule for ranks that share a card) take the VoteNet FSB, BR and
   GF FSB steps of the bench configuration (4 + 4 rows of a fixed global
   batch, N=40000 and 8192 candidates, GF at its CLI defaults with dropout
   0; Adam at 1e-3, BN momentum 0.5) from a common seeded state, the
   VoteNet votes' offsets zeroed so that vote FPS and grouping read exact
   coordinates: the loss, every gradient summed over the ranks and the BN
   buffers against world 1's step on the 8 rows. As the step runs, the
   loss, all gradients and all buffers, each as one vector, within 1e-4
   or 4 times world 1 against itself on the rows reversed (f32: only the
   order of the sums differs, and it flips ReLU masks, max-pool winners
   and ball-query slots within rounding of a tie; their counts printed);
   with world 1's discrete choices replayed (``Pinned``), every tensor
   within 1e-4 of its largest magnitude or 4 times its own error in the
   reversal; both ranks bitwise equal, two runs bitwise equal, each
   rank's launches a forward and a step checked; each step's wall and
   peak memory a rank.
   Then the JAX package's two-process contract (tests/test_multiprocess.py)
   for ``votenet_fsb`` (2 epochs, then ``--resume`` for a third),
   ``votenet_br`` and ``gf_fsb`` (1 epoch), two ``--multihost`` processes
   on the card, batch 4 each, on the 16-scan fixtures: equal epoch losses
   on both ranks, rank 0's checkpoints only, ``log_train.txt.rank1``, an
   evaluation in both logs. ``[preemption]``: ``votenet_fsb`` with
   ``--guard_every_steps 1`` in a process of its own, sent SIGTERM in its
   second epoch: exit 143, the checkpoint (epoch 0) bitwise the state
   after as many steps replayed here, ``--resume`` finishes; one
   ``guard.update`` timed for VoteNet's and GF's state. ``[profile]``:
   ``votenet_fsb.main --profile_dir`` over 16 steps writes a trace of steps
   10-15 naming the FPS, ball-query and grouping kernels.
10. Print each phase's seconds, the card's name and power limit, one JSON
   line with every kernel's numbers (times summed over the VoteNet FSB
   training path's shapes; launches by path, the GF, exact and
   data-parallel paths included), and as the last line ``{"ok": true,
   "device": {"platform": "gpu", ...}}``.

It exits nonzero without a CUDA device, and imports nothing of JAX.
``--kernels_only`` stops after phase 2 and prints its records as one JSON
line (to time two trees' kernels in one run; it is not a pass).
"""

from __future__ import annotations

import argparse
import importlib
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
# grouping backward: fixed-order f32 sums against the f64 plain backward
GROUP_GRAD_RTOL = 1e-5
# a sleep kernel of this many clock cycles (a few ms) keeps the device busy
# while the host queues the calls that a kernel timing measures
AHEAD_CYCLES = 10_000_000
# the paths the launch counters are read on; the VoteNet training recipes
# all train with --fps_candidates 8192, and only CenterRefine has the
# jitter head's layer; the GroupFree3D paths run at their CLI defaults
# (N=50000, FPS over the full cloud, no height feature)
SERVING = ("serving",)
TRAINING = ("training", "wsb", "br", "br_center_refine")
ALL_PATHS = SERVING + TRAINING
JITTER_PATH = ("br_center_refine",)
GF_TRAINING = ("gf_fsb", "gf_wsb", "gf_br", "gf_br_center_refine")
GF_PATHS = ("gf_serving",) + GF_TRAINING
GF_JITTER_PATH = ("gf_br_center_refine",)
BF16_TRAINING = ("training_bf16", "gf_fsb_bf16")
# the world-2 train steps (rank 0's launches, 4 rows a rank)
DP_PATHS = ("dp_votenet_fsb", "dp_votenet_br", "dp_gf_fsb")
DP_VOTENET = DP_PATHS[:2]
N_GF = 50000
# launches per forward (FPS, ball query, the fused grouping) and grouping
# backwards per train step, by model graph. A DA step runs two forwards
# and one backward: SA2-SA4 and vote clustering in each, and in
# CenterRefine the jitter head's layer in each forward and its backward in
# the source's only (the target's jitter prediction refines labels that
# are detached). GroupFree3D samples its queries by KPS (a top-k, no
# kernel): SA1-SA4 a forward, SA2-SA4 a backward; its CenterRefine graph
# adds the jitter head's layer, in evaluation too (it takes the GT centres)
PER_FORWARD = {"plain": (5, 5, 5), "da": (5, 5, 5), "da_jitter": (5, 6, 6),
               "gf": (4, 4, 4), "gf_da": (4, 4, 4),
               "gf_da_jitter": (4, 5, 5)}
BACKWARDS_PER_STEP = {"plain": 4, "da": 8, "da_jitter": 9, "gf": 3,
                      "gf_da": 6, "gf_da_jitter": 7}
# the checkpoint gate: the JAX package's scores of lad_f32 on the 100-scan
# shapefix val (subset FPS over 8192 candidates, 3 subsample seeds;
# evidence/round5/r5_ladeval_f32.out), mean and its own spread per IoU
GATE_CHECKPOINT = "evidence/round4/ckpt/lad_f32.tar.gz"
GATE = {0.25: (0.8210, 0.0064, (0.8234, 0.8138, 0.8258)),
        0.5: (0.6202, 0.0226, (0.6439, 0.5990, 0.6178))}
# the second checkpoint gate: the JAX package's bfloat16 checkpoint lad_t2
# (--bf16 --f32_tail 2) scored by its evaluate after 20 batches of BN
# recalibration on the shapefix train split
# (evidence/round5/queue/s2_ladder_bigval.sh,
# evidence/round5/r5_ladeval_t2.out, RESULTS.md:1036-1041): mean, spread
# and seeds per IoU. The card's mean must lie within GATE_T2_BAND spreads:
# the JAX spread is the subsample seeds' only, and bfloat16 products
# accumulate in another order on the TPU's matrix units than on Hopper's
# tensor cores
GATE_T2_CHECKPOINT = "evidence/round4/ckpt/lad_t2.tar.gz"
GATE_T2 = {0.25: (0.7571, 0.0056, (0.7636, 0.7543, 0.7535)),
           0.5: (0.4982, 0.0186, (0.4981, 0.5169, 0.4797))}
GATE_T2_BAND = 2
RECAL_BATCHES = 20  # --bn_recal_batches' default with --bf16
# the GroupFree3D learning check: the JAX package's run of GF FSB on the
# shapefix train split (evidence/round5/gflad/f32_config.json), its
# per-epoch losses and the in-loop mAP@0.25 at epoch 49 in f32_metrics.jsonl,
# its mAP@0.5 there in RESULTS.md:1256; the port's mean loss over epochs
# 40-49 must lie within LEARN_BAND of the JAX run's, its mAP@0.25 at epoch
# 49 at least LEARN_MIN_MAP (the 12-scan noise is +/-0.01-0.07,
# RESULTS.md:1266)
LEARN_METRICS = "evidence/round5/gflad/f32_metrics.jsonl"
LEARN_EPOCHS = 50
LEARN_BAND = (0.67, 1.5)
LEARN_MIN_MAP = 0.30
LEARN_JAX_MAP50 = 0.163


def require(cond, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_header() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1, inner: int = 1,
            ahead: bool = False) -> float:
    """Median milliseconds of `fn` over `reps` runs, CUDA events. With
    `inner` > 1 each run is `inner` back-to-back calls between one pair
    of events (divided by `inner`). With `ahead`, a sleep kernel is
    queued before the first event, so that the host has queued the calls
    before the device reaches them: the events then time the device's
    work, not the host's launch overhead (for a kernel comparison; an
    end-to-end time leaves it off)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(AHEAD_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fps_layouts(fps, b, n):
    """The layouts other than the wrapper's own worth timing on a (b, n)
    call: every cluster size that gives a block at least a warp's points,
    and one block of 1 to 16 warps with the fewest points a thread."""
    found = {fps.shard_plan(c, n) for c in (1, 2, 4, 8, 16) if n >= 32 * c}
    for threads in (32, 64, 128, 256, 512):
        points = [p for p in (1, 2, 4, 8, 16) if threads * p >= n]
        if points and threads * points[0] < 2 * n:
            found.add(fps.Plan(1, threads, points[0]))
    return sorted(found - {None, fps.plan(b, n)})


def check_fps(label, xyz, npoint, fps, reps, candidates=None,
              others=False, want_cluster=None):
    """Kernel vs plain FPS on one input; returns the per-shape record.
    With `others`, every other layout is held against the plain version
    and timed too. `want_cluster` tells which kind of layout the shape
    must take: True a cluster, False the capacity kernel."""
    import torch

    got = fps.furthest_point_sample(xyz, npoint, candidates=candidates)
    x = xyz[:, :candidates] if candidates else xyz
    want = fps._fps_torch(x, npoint)
    torch.cuda.synchronize()
    require(torch.equal(got, want),
            f"fps {label}: kernel != plain at"
            f" {(got != want).sum().item()} of {got.numel()} samples")
    b, n, _ = x.shape
    layout = fps.plan(b, n)
    if want_cluster is not None:
        require((layout.cluster > 1) if want_cluster else
                (layout.cluster == 0),
                f"fps {label}: layout {tuple(layout)} is not the kind this"
                " check is for")
    ms = cuda_ms(lambda: fps._fps_cuda(x, npoint), reps, ahead=True)
    plain = cuda_ms(lambda: fps._fps_torch(x, npoint), 2, ahead=True)
    bnd, by = bound_ms(FPS_OPS_PER_POINT * b * (npoint - 1) * n,
                       b * n * 12 + b * npoint * 4)
    per_sample = ms / (npoint - 1) * 1e3
    held = (f" (the card holds {fps.KERNEL.lib.fps_max_clusters(*layout)}"
            " such clusters at once)" if layout.cluster > 1 else "")
    print(f"  fps {label:14s} B={b} N={n} -> {npoint}: kernel {ms:.4f} ms"
          f" ({per_sample:.3f} us a sample), plain {plain:.3f} ms, bound"
          f" {bnd:.4f} ms ({by}), bit-exact; cluster {layout.cluster},"
          f" {layout.threads} threads, {layout.points} points a thread"
          + held)
    rec = dict(shape=label, ms=ms, plain_ms=plain, bound_ms=bnd,
               bound_by=by, max_abs_err=0, us_per_sample=per_sample,
               layout=tuple(layout))
    if others:
        rec["other_layouts"] = []
        for other in fps_layouts(fps, b, n):
            require(torch.equal(fps._fps_cuda(x, npoint, other), want),
                    f"fps {label}: layout {tuple(other)} != plain")
            t = cuda_ms(lambda: fps._fps_cuda(x, npoint, other), 3,
                        ahead=True)
            print(f"      as cluster {other.cluster}, {other.threads}"
                  f" threads, {other.points} points: {t:.4f} ms"
                  f" ({t / (npoint - 1) * 1e3:.3f} us a sample), bit-exact")
            rec["other_layouts"].append(dict(layout=tuple(other), ms=t))
    return rec


def fps_edge_clouds(xyz, device):
    """(label, cloud, npoint, want_cluster) for the FPS checks off the
    main paths; few samples each, since the plain version is a Python
    loop."""
    import torch

    gen = torch.Generator(device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    n = xyz.shape[1]
    padded = xyz.clone()
    padded[0, n - n // 10:] = 0.0  # padded tail
    padded[1] = 0.0  # all padding
    # duplicated points: a tie at every sample, between blocks of a
    # cluster (8192 points: 16 blocks of 512), between neighbouring lanes
    # and between the registers of one thread
    uniq = randn(1024, 3)
    i = torch.arange(8192, device=device)
    ties = torch.stack([uniq[i % 1024], uniq[i // 8], uniq[i % 512],
                        uniq[(i % 128) * 8]])
    # shards of a cluster that hold padding only: the first block's, one
    # in the middle, the last one's
    shards = randn(3, 8192, 3)
    shards[0, :512] = 0.0
    shards[1, 1024:1536] = 0.0
    shards[2, 8192 - 700:] = 0.0
    return (
        ("padded", padded, 2048, True),
        ("one_scan", xyz[:1], 512, True),
        ("n50000", randn(2, 50000, 3), 128, True),
        ("ties", ties, 600, True),
        ("pad_shards", shards, 256, True),
        ("n257", randn(3, 257, 3), 33, None),
        ("capacity", randn(1, 140000, 3), 16, False),
    )


def fps_floor(fps, device):
    """The serial floor of one sample: the kernel on rows of one point a
    thread (128 threads a block, or one warp), where the sweep is a dozen
    instructions and what remains is the reduction, the exchange and the
    barrier. Returns microseconds per sample by layout."""
    import torch

    floor = {}
    npoint = 1025
    for layout in (fps.Plan(1, 32, 1), *(fps.Plan(r, 128, 1)
                                         for r in (1, 2, 4, 8, 16))):
        n = layout.cluster * layout.threads
        x = torch.randn(B, n, 3, device=device,
                        generator=torch.Generator(device).manual_seed(n))
        require(torch.equal(fps._fps_cuda(x, 65, layout),
                            fps._fps_torch(x, 65)),
                f"fps floor: layout {tuple(layout)} != plain")
        ms = cuda_ms(lambda: fps._fps_cuda(x, npoint, layout), 5,
                     ahead=True)
        floor[tuple(layout)] = ms / (npoint - 1) * 1e3
    print("  fps serial floor, us a sample (cluster, threads, points): "
          + ", ".join(f"{k} {v:.3f}" for k, v in floor.items()))
    return floor


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


def tile_name(bq, tile) -> str:
    kind = ("centres" if tile.mapping == bq.CENTRES_IN_LANES else "points")
    return (f"{kind} {tile.centres}c x {tile.warps}w"
            + (f" x {tile.per_lane} a lane"
               if tile.mapping == bq.CENTRES_IN_LANES else ""))


def check_bq(label, xyz, ctr, radius, nsample, bq, reps):
    """Kernel vs plain ball query on one input, in every tile the plan
    may pick for its shape (the plan's own through the public wrapper);
    `reps` 0 checks without timing. Returns the per-shape record: the
    plan's tile and its time, and per tile the time and the distance tests
    executed, beside the tests the data needs."""
    import torch

    pi, ph = bq._ball_query_stratified_torch(xyz, ctr, radius, nsample)
    b, n, _ = xyz.shape
    m = ctr.shape[1]
    bucket = bq._bucket_size(n, nsample)
    # work this data needs: each slot scans up to its bucket's first hit
    base = torch.arange(nsample, device=xyz.device) * bucket
    span = torch.clamp(n - base, 0, bucket)
    tests = torch.where(ph, pi - base + 1, span).sum().item()
    chosen = bq.plan(b, n, m, nsample)
    tiles = bq.tiles(b, n, m, nsample)
    require(chosen in tiles, f"bq {label}: the plan's tile {chosen} is not"
                             " among the tiles checked")
    max_gap, boundary, per_tile = 0.0, 0, []
    for tile in tiles:
        counter = torch.zeros(1, dtype=torch.int64, device=xyz.device)
        if tile == chosen:
            ki, kh = bq.ball_query_stratified(xyz, ctr, radius, nsample,
                                              return_hit=True)
        ki2, kh2 = bq._ball_query_stratified_cuda(xyz, ctr, radius, nsample,
                                                  tile, counter)
        torch.cuda.synchronize()
        if tile == chosen:
            require(torch.equal(ki, ki2) and torch.equal(kh, kh2),
                    f"bq {label}: the wrapper did not take the plan's tile")
        name = tile_name(bq, tile)
        gap, tol, orphans = bq_gaps(xyz, ctr, radius, ki2, kh2, pi, ph)
        worst = gap.max().item() if gap.numel() else 0.0
        require(orphans == 0, f"bq {label} [{name}]: {orphans} centres"
                              " differ in slot-fill alone")
        require(bool((gap <= tol).all()),
                f"bq {label} [{name}]: disagreement {worst:.3e} from the"
                " radius, above the tolerance")
        max_gap, boundary = max(max_gap, worst), max(boundary, gap.numel())
        executed = counter.item()
        require(executed >= tests, f"bq {label} [{name}]: {executed} tests"
                                   f" executed, the data needs {tests}")
        rec = dict(tile=tuple(tile), name=name, executed=executed)
        if reps:
            rec["ms"] = cuda_ms(lambda: bq._ball_query_stratified_cuda(
                xyz, ctr, radius, nsample, tile), reps, ahead=True)
        per_tile.append(rec)
    head = (f"  bq  {label:14s} B={b} N={n} M={m} S={nsample} r={radius}"
            f" bucket={bucket}: {len(tiles)} tiles agree with the plain"
            f" version, {boundary} boundary disagreements (max |d2-r2|"
            f" {max_gap:.2e}), hit rate {ph.float().mean().item():.3f},"
            f" {tests} tests needed")
    if not reps:
        print(head)
        return dict(shape=label, max_abs_err=max_gap)
    mine = next(r for r in per_tile if r["tile"] == tuple(chosen))
    plain = cuda_ms(lambda: bq._ball_query_stratified_torch(
        xyz, ctr, radius, nsample), 3, ahead=True)
    bnd, by = bound_ms(BQ_OPS_PER_TEST * tests,
                       b * n * 12 + b * m * 12 + b * m * nsample * 5)
    print(head + f"; plan [{mine['name']}] kernel {mine['ms']:.4f} ms,"
          f" plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})")
    for r in per_tile:
        print(f"      [{r['name']}] {r['ms']:.4f} ms, {r['executed']} tests"
              f" executed ({r['executed'] / max(tests, 1):.2f} of needed)")
    return dict(shape=label, ms=mine["ms"], plain_ms=plain, bound_ms=bnd,
                bound_by=by, max_abs_err=max_gap, boundary_points=boundary,
                tests_needed=tests, tile=mine["name"], tiles=per_tile)


def bq_edge_inputs(device):
    """(label, xyz, centres, radius, nsample) for the ball-query checks off
    the main paths: what a tiling can get wrong."""
    import torch

    gen = torch.Generator(device).manual_seed(1)

    def cloud(*shape):
        return torch.rand(*shape, 3, device=device, generator=gen) * 2.0

    cases = []
    x = cloud(2, 1000)  # 8 live buckets of 16, the last of 104 points
    cases.append(("m33", x, x[:, :33].clone(), 0.3, 16))
    x = cloud(2, 3000)  # 24 live buckets of 64, the last of 56 points
    cases.append(("m257_s64", x, x[:, 5:262].clone(), 0.25, 64))
    x = cloud(3, 100)  # below one bucket
    cases.append(("n100_s1", x, x[:, :40].clone(), 0.5, 1))
    cases.append(("n100_s16", x, x[:, 30:70].clone(), 0.5, 16))
    # a centre far from every point, and one whose only hit is the last
    # point of the last live bucket (the others are in [0, 2)^3)
    x = cloud(2, 1500)
    x[:, -1] = 50.0
    c = x[:, :64].clone()
    c[:, 0] = 100.0
    c[:, 1] = 50.01
    cases.append(("lonely_last", x, c, 0.4, 16))
    # 64 points, each 32 times: every hit is a tie with later copies
    x = cloud(2, 64)[:, torch.arange(2048, device=device) % 64]
    cases.append(("duplicates", x, x[:, :128].clone(), 0.5, 32))
    x = cloud(1, 5000)
    cases.append(("b1_s64", x, x[:, :600].clone(), 0.2, 64))
    wide = torch.rand(2, 2048, 5, device=device, generator=gen) * 2.0
    cases.append(("strided", wide[..., 1:4], wide[:, :300, 1:4], 0.3, 32))
    return cases


def check_bq_edges(bq, device):
    import torch

    for label, x, c, r, s in bq_edge_inputs(device):
        check_bq(label, x, c, r, s, bq, reps=0)
        if label == "lonely_last":
            idx, hit = bq.ball_query_stratified(x, c, r, s, return_hit=True)
            n = x.shape[1]
            last = (n - 1) // bq._bucket_size(n, s)
            only = torch.zeros(s, dtype=torch.bool, device=device)
            only[last] = True
            require(not bool(hit[:, 0].any()) and bool((idx[:, 0] == 0).all()),
                    "bq: a centre with no hit must give index 0, no hit")
            require(bool((hit[:, 1] == only).all())
                    and bool((idx[:, 1] == n - 1).all()),
                    "bq: a centre whose only hit is the last point must"
                    " give that point in every slot")
        if label == "strided":
            require(not x.is_contiguous(), "bq: the strided case is not")


def check_group(label, points, ctr, radius, nsample, bq, grouping, reps):
    """Kernel vs plain stratified grouping at one main-path input
    (idx/hit from the ball query); returns (forward, backward) records.

    Forward: bit-exact. Backward: within GROUP_GRAD_RTOL of the plain
    backward computed in float64, relative to the largest gradient, and
    bitwise equal over two runs. `library_ms` is one ``torch.gather``
    call (forward) and its autograd backward. The backward's passes are
    timed apart by the profiler (`lists_ms`, `fold_ms`, `reduce_ms`)."""
    import types

    import torch

    idx, hit = bq.ball_query_stratified(points[..., :3], ctr, radius,
                                        nsample, return_hit=True)
    b, n, c = points.shape
    m = ctr.shape[1]
    gen = torch.Generator(points.device).manual_seed(nsample * c)
    gout = torch.randn((b, m, nsample, c), device=points.device,
                       generator=gen)
    cuda = grouping._GroupStratifiedCuda
    got = cuda.apply(points, idx, hit)
    want = grouping._group_points_stratified_torch(points, idx, hit)
    torch.cuda.synchronize()
    require(torch.equal(got, want),
            f"group {label}: forward kernel != plain at"
            f" {(got != want).sum().item()} of {got.numel()} values")

    ctx = types.SimpleNamespace(saved_tensors=(idx, hit), n=n)
    g1 = cuda.backward(ctx, gout)[0]
    g2 = cuda.backward(ctx, gout)[0]
    p64 = points.double().requires_grad_()
    (g64,) = torch.autograd.grad(
        grouping._group_points_stratified_torch(p64, idx, hit), p64,
        gout.double())
    torch.cuda.synchronize()
    scale = g64.abs().max().item()
    err = (g1.double() - g64).abs().max().item() / max(scale, 1e-30)
    require(err <= GROUP_GRAD_RTOL,
            f"group {label}: backward error {err:.2e} of the largest"
            f" gradient, above {GROUP_GRAD_RTOL}")
    require(torch.equal(g1, g2), f"group {label}: backward not bitwise"
                                 " repeatable")

    index = idx.reshape(b, m * nsample, 1).long().expand(-1, -1, c)
    pg = points.detach().requires_grad_()
    plain_out = grouping._group_points_stratified_torch(pg, idx, hit)
    lib_out = torch.gather(pg, 1, index)
    flat_gout = gout.reshape(b, m * nsample, c)
    kw = dict(reps=reps, inner=20, ahead=True)
    fwd_ms = cuda_ms(lambda: cuda.apply(points, idx, hit), **kw)
    fwd_plain = cuda_ms(lambda: grouping._group_points_stratified_torch(
        points, idx, hit), **kw)
    fwd_lib = cuda_ms(lambda: torch.gather(points, 1, index), **kw)
    bwd_ms = cuda_ms(lambda: cuda.backward(ctx, gout), **kw)
    # how uneven the backward's work is: hits per point
    flat = idx.long() + torch.arange(b, device=idx.device)[:, None, None] * n
    per_point = torch.bincount(flat[hit], minlength=b * n)
    passes = kernel_times(lambda: cuda.backward(ctx, gout), "group_bwd_")
    bwd_plain = cuda_ms(lambda: torch.autograd.grad(
        plain_out, pg, gout, retain_graph=True), **kw)
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(
        lib_out, pg, flat_gout, retain_graph=True), **kw)
    out_bytes = b * m * nsample * c * 4
    # the indices and hit flags, the rows gathered, the output
    fwd_bound, fwd_by = bound_ms(0, b * m * nsample * 5
                                 + gathered_rows(idx, n) * c * 4 + out_bytes)
    bwd_bound, bwd_by = bound_ms(b * m * nsample * c,  # one add each
                                 out_bytes + b * m * nsample * 5
                                 + b * n * c * 4)
    print(f"  group {label:12s} N={n} C={c} M={m} S={nsample}: forward"
          f" kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f}, gather"
          f" {fwd_lib:.4f}, bound {fwd_bound:.4f} ({fwd_by}), bit-exact;"
          f" backward kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f},"
          f" gather backward {bwd_lib:.4f}, bound {bwd_bound:.4f}"
          f" ({bwd_by}), error {err:.2e} of max |g|, repeatable;"
          f" hit rate {hit.float().mean().item():.3f}, hits per point"
          f" mean {per_point.float().mean().item():.2f} max"
          f" {per_point.max().item()}; backward passes "
          + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
    fwd = dict(shape=label, ms=fwd_ms, plain_ms=fwd_plain,
               library_ms=fwd_lib, bound_ms=fwd_bound, bound_by=fwd_by,
               max_abs_err=0)
    bwd = dict(shape=label, ms=bwd_ms, plain_ms=bwd_plain,
               library_ms=bwd_lib, bound_ms=bwd_bound, bound_by=bwd_by,
               max_abs_err=err * scale, rel_err=err,
               longest_list=per_point.max().item(),
               **{f"{k}_ms": v for k, v in passes.items()})
    return fwd, bwd


def gathered_rows(idx, n):
    """Distinct points (of the B*N) that a gather by `idx` (B, M, S) reads:
    the rows a grouping forward must move, each once however many slots
    take it (a centre that hits nothing takes one point in all its
    slots)."""
    import torch

    b = idx.shape[0]
    flat = idx.long() + torch.arange(b, device=idx.device)[:, None, None] * n
    return torch.unique(flat).numel()


def list_lengths(idx, hit, n):
    """Entries per point (B*N) of the grouping backward's lists: one for
    each slot that hits the point, and one for each centre whose first-hit
    slot (slot 0, index 0, for a centre with no hit) holds it: that
    centre's folded row of slot-filled slots."""
    import torch

    b = idx.shape[0]
    first = torch.where(hit.any(-1), hit.int().argmax(-1), 0)  # (B, M)
    first_idx = torch.gather(idx, 2, first[..., None])[..., 0]
    offset = torch.arange(b, device=idx.device)[:, None] * n
    flat = torch.cat([(idx.long() + offset[..., None])[hit],
                      (first_idx.long() + offset).reshape(-1)])
    return torch.bincount(flat, minlength=b * n)


def check_localize(label, xyz, feats, ctr, radius, nsample, bq, grouping,
                   reps, needs=(), scale=None):
    """The grouping fused with the localize step against its plain version
    at one input; returns (forward, backward) records, or None without
    `reps` (a check only). The ball query takes `radius`, the localize
    step divides by `scale` (default: the radius; the jitter head's layer
    passes 1.0, and its coordinates must then equal the un-normalized
    ones bit for bit).

    Forward: bit-exact. Gradients of xyz, features and the centres: each
    within GROUP_GRAD_RTOL of the plain backward in float64, relative to
    its largest entry, and bitwise equal over two runs. The backward is
    timed with the gradients the training path asks for at this call
    (`needs`, of "xyz", "features", "centres"): the kernel's by calling
    its passes directly, as the unfused backward's is, the plain one
    through autograd."""
    import torch

    idx, hit = bq.ball_query_stratified(xyz, ctr, radius, nsample,
                                        return_hit=True)
    b, n, _ = xyz.shape
    m = ctr.shape[1]
    c = 0 if feats is None else feats.shape[-1]
    query_radius, radius = radius, radius if scale is None else scale
    got = grouping.group_localize_stratified(xyz, feats, ctr, idx, hit,
                                             radius)
    want = grouping._group_localize_stratified_torch(xyz, feats, ctr, idx,
                                                     hit, radius)
    torch.cuda.synchronize()
    require(got.shape == (b, m, nsample, 3 + c) and torch.equal(got, want),
            f"localize {label}: forward kernel != plain at"
            f" {(got != want).sum().item()} of {got.numel()} values")
    if radius == 1.0:
        local = (grouping._group_points_stratified_torch(xyz, idx, hit)
                 - ctr[:, :, None, :])
        require(torch.equal(got[..., :3], local),
                f"localize {label}: radius 1.0 differs from the"
                " un-normalized coordinates")
    del got, want

    gen = torch.Generator(xyz.device).manual_seed(nsample * (c + 3))
    gout = torch.randn((b, m, nsample, 3 + c), device=xyz.device,
                       generator=gen)
    names = ["xyz", "centres"] + (["features"] if c else [])

    def leaves(dtype):
        made = {"xyz": xyz, "centres": ctr, "features": feats}
        # a copy: the main path's tensors come from inference mode
        return {k: made[k].detach().to(dtype, copy=True).requires_grad_()
                for k in names}

    def grads(fn, dtype, wanted):
        lv = leaves(dtype)
        out = fn(lv["xyz"], lv.get("features"), lv["centres"], idx, hit,
                 radius)
        return dict(zip(wanted, torch.autograd.grad(
            out, [lv[k] for k in wanted], gout.to(dtype))))

    g1 = grads(grouping.group_localize_stratified, torch.float32, names)
    g2 = grads(grouping.group_localize_stratified, torch.float32, names)
    g64 = grads(grouping._group_localize_stratified_torch, torch.float64,
                names)
    torch.cuda.synchronize()
    errs, worst_abs = {}, 0.0
    for k in names:
        peak = g64[k].abs().max().item()
        gap = (g1[k].double() - g64[k]).abs().max().item()
        errs[k] = gap / max(peak, 1e-30)
        worst_abs = max(worst_abs, gap)
        require(errs[k] <= GROUP_GRAD_RTOL,
                f"localize {label}: gradient of {k} off by {errs[k]:.2e} of"
                f" its largest entry, above {GROUP_GRAD_RTOL}")
        require(torch.equal(g1[k], g2[k]),
                f"localize {label}: gradient of {k} not bitwise repeatable")
    del g1, g2, g64
    said = ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
    if scale is not None:
        said += f"; query r={query_radius}, localize /{radius}"
    if not reps:
        print(f"  localize {label:9s} N={n} C={c} M={m} S={nsample}: forward"
              f" bit-exact; gradients repeatable, errors of max |g|: {said}")
        return None

    kw = dict(reps=reps, inner=20, ahead=True)
    fused = grouping.group_localize_stratified
    plain = grouping._group_localize_stratified_torch
    fwd_ms = cuda_ms(lambda: fused(xyz, feats, ctr, idx, hit, radius), **kw)
    fwd_plain = cuda_ms(lambda: plain(xyz, feats, ctr, idx, hit, radius),
                        **kw)
    # the indices and hit flags, the rows gathered, the centres
    in_bytes = (b * m * nsample * 5 + gathered_rows(idx, n) * (3 + c) * 4
                + b * m * 12)
    out_bytes = b * m * nsample * (3 + c) * 4
    fwd_bound, fwd_by = bound_ms(2 * 3 * b * m * nsample,
                                 in_bytes + out_bytes)
    fwd = dict(shape=label, ms=fwd_ms, plain_ms=fwd_plain, library_ms=None,
               bound_ms=fwd_bound, bound_by=fwd_by, max_abs_err=0)
    line = (f"  localize {label:9s} N={n} C={c} M={m} S={nsample}: forward"
            f" kernel {fwd_ms:.4f} ms, plain (cat, gather, sub, div, cat)"
            f" {fwd_plain:.4f}, bound {fwd_bound:.4f} ({fwd_by}),"
            f" bit-exact; gradients repeatable, errors of max |g|: {said}")
    bwd = None
    if needs:
        wanted = [k for k in names if k in needs]
        lv = {k: v if k in wanted else v.detach()
              for k, v in leaves(torch.float32).items()}
        plain_out = plain(lv["xyz"], lv.get("features"), lv["centres"], idx,
                          hit, radius)
        targets = [lv[k] for k in wanted]

        def fused_backward():
            return grouping._backward_passes(
                gout, idx, hit, n, radius, want_xyz="xyz" in wanted,
                want_centres="centres" in wanted)

        bwd_ms = cuda_ms(fused_backward, **kw)
        bwd_plain = cuda_ms(lambda: torch.autograd.grad(
            plain_out, targets, gout, retain_graph=True), **kw)
        passes = kernel_times(fused_backward, "group_")
        bwd_bound, bwd_by = bound_ms(
            b * m * nsample * (3 + c),  # one add each
            out_bytes + b * m * nsample * 5 + b * n * (3 + c) * 4
            + (b * m * 12 if "centres" in wanted else 0))
        lengths = list_lengths(idx, hit, n)
        listed = lengths[lengths > 0].float()
        longest = lengths.max().item()
        no_hit = (~hit.any(-1)).sum().item()
        bwd = dict(shape=label, ms=bwd_ms, plain_ms=bwd_plain,
                   library_ms=None, bound_ms=bwd_bound, bound_by=bwd_by,
                   max_abs_err=worst_abs, rel_err=max(errs.values()),
                   gradients=wanted, longest_list=longest,
                   **{f"{k}_ms": v for k, v in passes.items()})
        line += (f"; backward ({', '.join(wanted)}) kernel {bwd_ms:.4f} ms,"
                 f" plain {bwd_plain:.4f}, bound {bwd_bound:.4f} ({bwd_by}),"
                 " passes "
                 + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
                 + f"; lists: longest {longest} entries, mean"
                 f" {listed.mean().item():.2f} over {listed.numel()} points,"
                 f" {no_hit} of {b * m} centres hit no point")
    print(line)
    return fwd, bwd


def summarize(name, kernel, source, records, launches, path):
    """One kernel's line: times summed over the records on `path`
    (each record lists the paths it is on), so `ms` is that kernel's
    time per forward (or per backward) on that path."""
    main = [r for r in records if path in r.get("paths", ())]
    ops_bound = sum(r["bound_ms"] for r in main if r["bound_by"] ==
                    "operations")
    byte_bound = sum(r["bound_ms"] for r in main if r["bound_by"] ==
                     "bytes")
    lib = [r.get("library_ms") for r in main]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": kernel.replaces, "launches": launches[path],
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": ops_bound + byte_bound,
        "bound_by": "operations" if ops_bound >= byte_bound else "bytes",
        "library_ms": None if None in lib else sum(lib),
        "per_shape": records,
    }


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def kernel_times(fn, prefix, calls=20):
    """Device milliseconds per call of `fn`, by kernel, for the kernels
    whose name holds `prefix` (torch.profiler); the key is the name's part
    between the prefix and ``_kernel``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    times = {}
    for _ in range(3):  # a trace now and then comes back without kernels
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and prefix in e.key:
                name = e.key.split(prefix, 1)[1].split("_kernel", 1)[0]
                times[name] = (times.get(name, 0.0)
                               + _device_us(e) / 1e3 / calls)
        if times:
            break
    return times


def step_phases(model, opt, loss_fn, batches, bn_momentum, jitter=False,
                reps=5):
    """Median device milliseconds of each phase of a train step (the
    sequence of `votenet.make_train_step`, or with two batches, source
    and target, of `make_da_train_step`), CUDA events between phases.
    `loss_fn` maps the list of end_points dicts to the loss."""
    import torch

    from backtoreality_tpu_torch.nn import set_bn_momentum
    from backtoreality_tpu_torch.train.common import model_args

    forwards = (["forward"] if len(batches) == 1
                else [f"forward_{d}" for d in "ST"])
    names = (*forwards, "loss", "backward", "optimizer")
    times = {k: [] for k in names}
    model.train()
    set_bn_momentum(model, bn_momentum)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        ev[0].record()
        end_points = []
        for i, batch in enumerate(batches):
            end_points.append({**batch, **model(*model_args(batch, jitter))})
            ev[i + 1].record()
        loss = loss_fn(end_points)
        ev[-3].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[-2].record()
        opt.step()
        ev[-1].record()
        ev[-1].synchronize()
        for i, k in enumerate(names):
            times[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: statistics.median(v) for k, v in times.items()}


def profile_steps(fn, label, steps=3):
    """Device time by kernel over `steps` calls of `fn` (torch.profiler);
    prints the table and returns the kernels' device milliseconds per
    call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    table = prof.key_averages()
    # kernels are the device-side events; the CPU-side op entries carry
    # the same time again, as does any user annotation
    dev_ms = sum(_device_us(e) for e in table
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 ) / 1e3 / steps
    print(f"[profile] {steps} {label}, by self device time:"
          f" {dev_ms:.3f} ms of kernels per call")
    print(table.table(sort_by="self_cuda_time_total", row_limit=25))
    return dev_ms


def op_device_ms(fn, steps=1):
    """({op: device ms per call}, kernels' device ms per call) over
    `steps` calls of `fn` (torch.profiler): each kernel's time goes to the
    PyTorch op that launched it. One call by default: the profiler takes
    seconds to sort a train step's ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    ops, dev = {}, 0.0
    for e in prof.key_averages():
        ms = _device_us(e) / 1e3 / steps
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev += ms
        elif ms:
            ops[e.key] = ops.get(e.key, 0.0) + ms
    return ops, dev


def determinism_cost(label, run, fill=False):
    """What the determinism switch costs one train step: its wall (CUDA
    events, median of 3 after a warm-up) and its kernels' device time
    with the switch off and on as the entry points set it
    (`common.make_deterministic`: no NaN fill of new tensors), and with
    `fill` also on with that fill; the three ops whose device time grew
    the most from off to on. Leaves the switch as the entry points set
    it."""
    import torch

    from backtoreality_tpu_torch.train.common import make_deterministic

    out = {}
    settings = [("off", False, False), ("on", True, False)]
    if fill:
        settings.append(("on+fill", True, True))
    for name, mode, nan_fill in settings:
        torch.use_deterministic_algorithms(mode)
        torch.utils.deterministic.fill_uninitialized_memory = nan_fill
        ms = cuda_ms(run, reps=3, warmup=1)
        ops, dev = op_device_ms(run)
        out[name] = dict(ms=ms, device_ms=dev, ops=ops)
    make_deterministic()
    off, on = out["off"]["ops"], out["on"]["ops"]
    grew = sorted(((on.get(k, 0.0) - off.get(k, 0.0), k)
                   for k in set(on) | set(off)), reverse=True)[:3]
    print(f"[determinism cost] {label}: wall "
          + ", ".join(f"{k} {v['ms']:.3f}" for k, v in out.items())
          + " ms; kernels "
          + ", ".join(f"{k} {v['device_ms']:.3f}" for k, v in out.items())
          + " ms; grew most (off -> on): "
          + "; ".join(f"{k} {off.get(k, 0.0):.3f} -> {on.get(k, 0.0):.3f}"
                      f" ms" for _, k in grew))
    out["grew"] = [k for _, k in grew]
    return out


def check_determinism(label, model, opt, run):
    """Two steps from one state (the model's, the optimizer's, and the
    global RNG's for the dropout draws) and one batch: every parameter
    tensor must come out bitwise equal. Leaves the model and the optimizer
    in the state of the first step taken."""
    import copy

    import torch

    state = copy.deepcopy(model.state_dict())
    opt_state = copy.deepcopy(opt.state_dict())
    after = []
    for _ in range(2):
        model.load_state_dict(state)
        # a copy: the optimizer keeps the tensors it is given and steps
        # them in place
        opt.load_state_dict(copy.deepcopy(opt_state))
        torch.manual_seed(1)
        run()
        after.append([p.detach().clone() for p in model.parameters()])
    differ = sum(not torch.equal(a, b) for a, b in zip(*after))
    print(f"[determinism] {label}: two steps from one state and batch:"
          f" {differ} of {len(after[0])} parameter tensors differ bitwise")
    require(differ == 0, f"{label}: {differ} parameter tensors differ"
            " bitwise between two steps from one state")


def reset(counters):
    for k in counters:
        k.launches = 0
        k.backward_launches = 0


def read_counts(counters) -> dict:
    """The launch counters by name (counters: FPS, ball query, grouping,
    fused grouping)."""
    fps_k, bq_k, group_k, localize_k = counters
    return {"fps": fps_k.launches, "ball_query": bq_k.launches,
            "group_stratified": group_k.launches,
            "group_stratified_backward": group_k.backward_launches,
            "group_localize_stratified": localize_k.launches,
            "group_localize_stratified_backward":
                localize_k.backward_launches}


def check_counts(label, launches, kind, forwards, steps):
    """Launches on a path against the model graph's counts: `forwards`
    forwards (a DA step runs two), `steps` train steps."""
    want = dict(zip(("fps", "ball_query", "group_localize_stratified"),
                    (n * forwards for n in PER_FORWARD[kind])))
    want["group_stratified"] = want["group_localize_stratified"]
    backward = BACKWARDS_PER_STEP[kind] * steps
    want["group_stratified_backward"] = backward
    want["group_localize_stratified_backward"] = backward
    for name, n in want.items():
        require(launches[name] == n,
                f"{label}: {name} launched {launches[name]} times, expected"
                f" {n} ({forwards} forwards, {steps} steps)")


def train_phase(scans, tmp, cfg, counters, header):
    """The FSB entry point on the card, then the bench-config step: wall,
    phases, kernels, what the determinism switch costs it, and the FSB
    and WSB steps gated on bitwise repeatability. Returns the launches and
    the step's numbers."""
    import torch

    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.train import common, evaluate, votenet
    from backtoreality_tpu_torch.train import votenet_fsb

    log = pathlib.Path(tmp) / "fsb_log"
    epochs = 2
    reset(counters)
    t0 = time.perf_counter()
    votenet_fsb.main([
        "--data_root", str(scans), "--train_split", "all", "--val_split",
        "all", "--log_dir", str(log), "--device", "cuda", "--num_point",
        str(N), "--batch_size", str(B), "--fps_candidates", "8192",
        "--max_epoch", str(epochs), "--eval_freq", str(epochs)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = epochs * (NUM_SCANS // B)
    forwards = steps + math.ceil(NUM_SCANS / B)  # + one evaluation
    launches = read_counts(counters)
    print(f"[training path] votenet_fsb.main: {steps} steps + one"
          f" evaluation over {NUM_SCANS} scans in {train_s:.1f} s;"
          f" launches {launches}")
    check_counts("training", launches, "plain", forwards, steps)
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    require(len(losses) == epochs and all(map(math.isfinite, losses)),
            f"training losses not finite: {losses}")
    print(f"  epoch losses {losses}")
    results = evaluate.main(["--checkpoint_path", str(log / "checkpoint.tar"),
                             "--data_root", str(scans), "--split", "all",
                             "--num_point", str(N), "--batch_size", str(B),
                             "--device", "cuda"])
    require(all(math.isfinite(m["mAP"]) for m in results.values()),
            "evaluate on the trained checkpoint: non-finite mAP")

    # the bench.py configuration on a fixed batch
    flags = votenet.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--fps_candidates", "8192"])
    torch.manual_seed(0)
    model = votenet.build_model(flags, cfg).cuda()
    opt = common.make_optimizer(model.parameters(), "adam", lr0=1e-3)
    step = votenet.make_train_step(model, opt, vote_losses.get_loss, cfg)
    ds = DetectionDataset(cfg, scans, split="all", num_points=N,
                          use_height=True, augment=True)
    batch = votenet.to_device(next(iter(DetectionDataLoader(
        ds, B, shuffle=False, prefetch=0))), "cuda")
    for _ in range(2):
        aux = step(batch, 0.5)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(batch, 0.5), reps=10, warmup=0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    aux = step(batch, 0.5)
    require(math.isfinite(aux["loss"].item()), "bench step loss not finite")
    print(f"[train step] VoteNet FSB B={B} N={N} fps_candidates=8192, Adam"
          f" lr 1e-3, BN momentum 0.5: {step_ms:.3f} ms per step (median"
          f" of 10 after 2 warm-ups), {B / step_ms * 1e3:.1f} scenes/s,"
          f" peak {peak_gb:.2f} GiB, loss {aux['loss'].item():.4f}"
          f"  | {header}")
    phases = step_phases(model, opt,
                         lambda eps: vote_losses.get_loss(eps[0], cfg)[0],
                         [batch], 0.5)
    print("  phases (median of 5, CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in phases.items()))
    dev_ms = profile_steps(lambda: step(batch, 0.5), "train steps")
    print(f"  device busy {dev_ms / step_ms:.3f} of the unprofiled step"
          f" ({dev_ms:.3f} of {step_ms:.3f} ms)")
    determinism_cost("VoteNet FSB step", lambda: step(batch, 0.5),
                     fill=True)

    # bitwise determinism of a whole step, gated (the switch is on)
    check_determinism("VoteNet FSB", model, opt, lambda: step(batch, 0.5))
    # and of WSB's: the weak criterion, the centres jittered
    wsb_batch = votenet.to_device(next(iter(DetectionDataLoader(
        DetectionDataset(cfg, scans, split="all", num_points=N,
                         use_height=True, augment=True, center_jitter=0.1),
        B, shuffle=False, prefetch=0))), "cuda")
    wsb_step = votenet.make_train_step(model, opt, vote_losses.get_loss_weak,
                                       cfg)
    check_determinism("VoteNet WSB", model, opt,
                      lambda: wsb_step(wsb_batch, 0.5))
    return launches, dict(ms=step_ms, device_ms=dev_ms, peak_gb=peak_gb)


def recipe_phase(scans, virtual, tmp, counters):
    """WSB, BR and BR+CenterRefine through their entry points on the card:
    one epoch (2 steps) and one evaluation each at B=8, N=40000,
    --fps_candidates 8192, with the launch counts checked per recipe;
    BR's checkpoint is grafted into CenterRefine, and the CenterRefine
    checkpoint goes through ``evaluate --kind da_jitter``. Returns the
    launches by recipe."""
    import torch

    from backtoreality_tpu_torch.train import (evaluate, votenet_br,
                                               votenet_br_center_refine,
                                               votenet_wsb)

    tmp = pathlib.Path(tmp)
    steps = NUM_SCANS // B  # one epoch; both fixtures hold NUM_SCANS scans
    evals = math.ceil(NUM_SCANS / B)
    launches = {}
    for recipe, entry, kind in (
            ("wsb", votenet_wsb, "plain"), ("br", votenet_br, "da"),
            ("br_center_refine", votenet_br_center_refine, "da_jitter")):
        log = tmp / f"{recipe}_log"
        args = ["--data_root", str(scans), "--train_split", "all",
                "--val_split", "all", "--log_dir", str(log), "--device",
                "cuda", "--num_point", str(N), "--batch_size", str(B),
                "--fps_candidates", "8192", "--max_epoch", "1",
                "--eval_freq", "1"]
        if kind != "plain":
            args += ["--source_data_root", str(virtual)]
        if kind == "da_jitter":
            args += ["--checkpoint_path", str(tmp / "br_log/train_BR.tar")]
        reset(counters)
        t0 = time.perf_counter()
        entry.main(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[recipe] = read_counts(counters)
        forwards = (steps if kind == "plain" else 2 * steps) + evals
        print(f"[training path: {recipe}] votenet_{recipe}.main: {steps}"
              f" steps + one evaluation in {secs:.1f} s; launches"
              f" {launches[recipe]}")
        check_counts(recipe, launches[recipe], kind, forwards, steps)
        rows = [json.loads(line) for line in
                (log / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in rows if "loss" in r]
        maps = [r["mAP"] for r in rows if "mAP" in r]
        require(len(losses) == 1 and len(maps) == 1
                and all(map(math.isfinite, losses + maps)),
                f"{recipe}: loss {losses}, mAP {maps}")
        print(f"  epoch loss {losses[0]:.4f}, eval mAP@0.25 {maps[0]:.4f}")
        if kind == "da_jitter":
            restores = [line.split("] ", 1)[1] for line in
                        (log / "log_train.txt").read_text().splitlines()
                        if "partial restore" in line]
            require(len(restores) == 2
                    and not any("copied 0 " in r for r in restores),
                    f"BR -> CenterRefine graft: {restores}")
            print("  BR grafted into CenterRefine: params "
                  + "; running statistics ".join(restores))
    results = evaluate.main([
        "--kind", "da_jitter", "--checkpoint_path",
        str(tmp / "br_center_refine_log/train_BR_CenterRefine.tar"),
        "--data_root", str(scans), "--split", "all", "--num_point", str(N),
        "--batch_size", str(B), "--fps_candidates", "8192", "--device",
        "cuda"])
    require(all(math.isfinite(m["mAP"]) for m in results.values()),
            "evaluate --kind da_jitter: non-finite mAP")
    return launches


def da_step_phase(scans, virtual, cfg, header):
    """The BR and the CenterRefine train step at the bench configuration
    (B=8, N=40000, --fps_candidates 8192, Adam at lr 1e-3, BN momentum
    0.5; epoch 30 for the label refinement) on one fixed pair of batches:
    wall time (CUDA events, median of 10 after 2 warm-ups), phases,
    kernels' device time (profiler), peak memory, what the determinism
    switch costs, and bitwise repeatability (gated)."""
    import torch

    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.train import common, votenet

    def first_batch(root, split, center_jitter):
        ds = DetectionDataset(cfg, root, split=split, num_points=N,
                              use_height=True, augment=True,
                              center_jitter=center_jitter)
        return votenet.to_device(next(iter(DetectionDataLoader(
            ds, B, shuffle=False, prefetch=0))), "cuda")

    # as `_train_loop_da`: the target is jittered, the source only for
    # CenterRefine
    target = first_batch(scans, "all", 0.1)
    flags = votenet.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--fps_candidates", "8192"])
    epoch = 30
    out = {}
    for recipe, kind in (("br", "da"), ("br_center_refine", "da_jitter")):
        jitter = kind == "da_jitter"
        batches = [first_batch(virtual, "train_aug", 0.1 if jitter else 0.0),
                   target]
        torch.manual_seed(0)
        model = votenet.build_model(flags, cfg, kind).cuda()
        opt = common.make_optimizer(model.parameters(), "adam", lr0=1e-3)
        step = votenet.make_da_train_step(model, opt, cfg, jitter=jitter)

        def run():
            return step(*batches, 0.5, epoch)

        for _ in range(2):
            run()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, reps=10, warmup=0)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        aux = run()
        require(math.isfinite(aux["loss"].item()),
                f"{recipe} step loss not finite")
        print(f"[da step] VoteNet {recipe} B={B}+{B} N={N}"
              " fps_candidates=8192, Adam lr 1e-3, BN momentum 0.5:"
              f" {ms:.3f} ms per step (median of 10 after 2 warm-ups),"
              f" {2 * B / ms * 1e3:.1f} scenes/s, peak {peak_gb:.2f} GiB,"
              f" loss {aux['loss'].item():.4f}  | {header}")

        def loss_fn(eps):
            if jitter:
                return vote_losses.get_loss_DA_jitter(*eps, epoch, cfg)[0]
            return vote_losses.get_loss_DA(*eps, cfg)[0]

        phases = step_phases(model, opt, loss_fn, batches, 0.5, jitter)
        print("  phases (median of 5, CUDA events): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in phases.items()))
        dev_ms = profile_steps(run, f"{recipe} steps")
        print(f"  device busy {dev_ms / ms:.3f} of the unprofiled step"
              f" ({dev_ms:.3f} of {ms:.3f} ms)")
        determinism_cost(f"VoteNet {recipe} step", run)
        check_determinism(f"VoteNet {recipe}", model, opt, run)
        out[recipe] = dict(ms=ms, device_ms=dev_ms, peak_gb=peak_gb,
                           phases=phases)
        del model, opt, step
    return out


def check_half_refused(xyz, feats, ctr, fps, bq, grouping, counters):
    """Every kernel's wrapper raises on bfloat16 and float16 inputs, and
    launches nothing: a bfloat16 path must promote to float32 itself."""
    import torch

    reset(counters)
    idx, hit = bq.ball_query_stratified(xyz, ctr, 0.4, 32, return_hit=True)
    calls = {
        "fps": lambda h: fps.furthest_point_sample(xyz.to(h), 64),
        "ball_query": lambda h: bq.ball_query_stratified(
            xyz.to(h), ctr.to(h), 0.4, 32),
        "group_stratified": lambda h: grouping.group_points_stratified(
            feats.to(h), idx, hit),
        "group_localize_stratified": lambda h:
            grouping.group_localize_stratified(xyz, feats.to(h), ctr, idx,
                                               hit, 0.4)}
    for name, call in calls.items():
        for half in (torch.bfloat16, torch.float16):
            try:
                call(half)
            except TypeError:
                continue
            require(False, f"{name}: the wrapper took a {half} input")
    launched = {k: v for k, v in read_counts(counters).items() if v}
    require(launched == {"ball_query": 1},
            f"launches on refused inputs: {launched}")
    print("[kernels] every wrapper raises TypeError on bfloat16 and float16"
          " inputs, launching nothing")


def bf16_step(label, model, opt, step, batches, header, f32):
    """A bfloat16 train step on fixed batches: wall (median of 10 CUDA-event
    timings after 2 warm-ups), peak memory, kernels' device time and busy
    share beside the float32 step's (`f32`), and bitwise repeatability
    (gated). Returns the numbers."""
    import torch

    def run():
        return step(*batches)

    for _ in range(2):
        run()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(run, reps=10, warmup=0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    aux = run()
    require(math.isfinite(aux["loss"].item()), f"{label}: loss not finite")
    dev_ms = profile_steps(run, f"{label} steps")
    print(f"[train step] {label}: {ms:.3f} ms per step (median of 10 after"
          f" 2 warm-ups), peak {peak_gb:.2f} GiB, kernels {dev_ms:.3f} ms,"
          f" device busy {dev_ms / ms:.3f}, loss {aux['loss'].item():.4f};"
          f" float32: {f32['ms']:.3f} ms, peak {f32['peak_gb']:.2f} GiB,"
          f" kernels {f32['device_ms']:.3f} ms  | {header}")
    check_determinism(label, model, opt, run)
    return dict(ms=ms, device_ms=dev_ms, peak_gb=peak_gb)


def bf16_phase(scans, tmp, cfg, counters, header, f32, fps, bq, grouping):
    """VoteNet with --bf16 --f32_tail 2. The FSB step at the bench
    configuration (`bf16_step`, beside the float32 step `f32`); on one
    forward of that model, the kernels held against their plain versions
    at this path's inputs (the features reach the grouping as float32,
    promoted from bfloat16); then ``votenet_fsb.main`` for one epoch of 2
    steps and one evaluation, which first recalibrates BN over 20 train
    batches, with the float32 path's launches a forward and backwards a
    step. Returns the launches."""
    import torch

    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.train import common, votenet, votenet_fsb

    flags = votenet.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--fps_candidates", "8192", "--bf16", "--f32_tail", "2"])
    torch.manual_seed(0)
    model = votenet.build_model(flags, cfg).cuda()
    opt = common.make_optimizer(model.parameters(), "adam", lr0=1e-3)
    step = votenet.make_train_step(model, opt, vote_losses.get_loss, cfg)
    ds = DetectionDataset(cfg, scans, split="all", num_points=N,
                          use_height=True, augment=True)
    batch = votenet.to_device(next(iter(DetectionDataLoader(
        ds, B, shuffle=False, prefetch=0))), "cuda")
    bf16_step(f"VoteNet FSB --bf16 --f32_tail 2 B={B} N={N}"
              " fps_candidates=8192, Adam lr 1e-3, BN momentum 0.5", model,
              opt, step, (batch, 0.5), header, f32)

    model.eval()
    with torch.no_grad():
        ep = model(batch["point_clouds"])
    require(ep["sa1_features"].dtype == torch.bfloat16
            and ep["fp2_features"].dtype == torch.float32,
            "bf16 path: sa1 features must be bfloat16, fp2's (f32_tail 2)"
            " float32")
    check_fps("vote_agg (bf16 path)", ep["vote_xyz"], 256, fps, reps=1)
    check_bq("sa2 (bf16 path)", ep["sa1_xyz"], ep["sa2_xyz"], 0.4, 32, bq,
             reps=0)
    check_localize("sa2 (bf16 path)", ep["sa1_xyz"],
                   ep["sa1_features"].float(), ep["sa2_xyz"], 0.4, 32, bq,
                   grouping, reps=0, needs=("features",))
    del model, opt, step, ep

    log = pathlib.Path(tmp) / "fsb_bf16_log"
    steps = NUM_SCANS // B
    reset(counters)
    t0 = time.perf_counter()
    votenet_fsb.main([
        "--data_root", str(scans), "--train_split", "all", "--val_split",
        "all", "--log_dir", str(log), "--device", "cuda", "--num_point",
        str(N), "--batch_size", str(B), "--fps_candidates", "8192",
        "--bf16", "--f32_tail", "2", "--max_epoch", "1", "--eval_freq",
        "1"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    print(f"[training path: fsb --bf16 --f32_tail 2] votenet_fsb.main:"
          f" {steps} steps, {RECAL_BATCHES} recalibration batches and one"
          f" evaluation in {secs:.1f} s; launches {launches}")
    check_counts("fsb --bf16", launches, "plain",
                 steps + RECAL_BATCHES + math.ceil(NUM_SCANS / B), steps)
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    maps = [r["mAP"] for r in rows if "mAP" in r]
    require(len(losses) == 1 and len(maps) == 1
            and all(map(math.isfinite, losses + maps)),
            f"fsb --bf16: loss {losses}, mAP {maps}")
    print(f"  epoch loss {losses[0]:.4f}, eval mAP@0.25 {maps[0]:.4f}")
    return launches


def gf_bf16_phase(scans, tmp, cfg, counters, header, f32, bq, grouping):
    """GroupFree3D with --bf16 --f32_tail 2 at its CLI defaults: the FSB
    step (`bf16_step`, beside the float32 step `f32`), the SA2 grouping
    held against its plain version at this path's input, and
    ``gf_fsb.main`` for one epoch of 2 steps and one evaluation after 20
    batches of recalibration, with the float32 path's launches. Returns
    the launches."""
    import torch

    from backtoreality_tpu_torch.losses import groupfree as gf_losses
    from backtoreality_tpu_torch.train import common, gf_fsb, groupfree

    flags = groupfree.add_flags(argparse.ArgumentParser()).parse_args(
        ["--bf16", "--f32_tail", "2"])
    steps = NUM_SCANS // B
    torch.manual_seed(0)
    model = groupfree.build_model(flags, cfg).cuda()
    opt = common.make_gf_optimizer(
        model, common.make_gf_schedule(flags.learning_rate, flags, steps),
        common.make_gf_schedule(flags.decoder_learning_rate, flags, steps),
        flags.weight_decay, flags.clip_norm)
    step = groupfree.make_train_step(model, opt, gf_losses.get_loss, cfg,
                                     groupfree.loss_kwargs(flags))
    batch = gf_first_batch(scans, cfg, use_height=False, augment=True)
    bf16_step(f"GroupFree3D FSB --bf16 --f32_tail 2 B={B} N={N_GF} (CLI"
              " defaults)", model, opt, step, (batch, flags.bn_momentum),
              header, f32)
    model.eval()
    with torch.no_grad():
        ep = model(batch["point_clouds"])
    require(ep["sa1_features"].dtype == torch.bfloat16
            and ep["fp2_features"].dtype == torch.float32,
            "GF bf16 path: sa1 features must be bfloat16, fp2's float32")
    check_localize("GF sa2 (bf16 path)", ep["sa1_xyz"],
                   ep["sa1_features"].float(), ep["sa2_xyz"], 0.4, 32, bq,
                   grouping, reps=0, needs=("features",))
    del model, opt, step, ep

    log = pathlib.Path(tmp) / "gf_fsb_bf16_log"
    reset(counters)
    t0 = time.perf_counter()
    gf_fsb.main(["--data_root", str(scans), "--train_split", "all",
                 "--val_split", "all", "--log_dir", str(log), "--device",
                 "cuda", "--batch_size", str(B), "--bf16", "--f32_tail", "2",
                 "--max_epoch", "1", "--val_freq", "1"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    print(f"[training path: gf_fsb --bf16 --f32_tail 2] gf_fsb.main: {steps}"
          f" steps, {RECAL_BATCHES} recalibration batches and one evaluation"
          f" in {secs:.1f} s; launches {launches}")
    check_counts("gf_fsb --bf16", launches, "gf",
                 steps + RECAL_BATCHES + math.ceil(NUM_SCANS / B), steps)
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    maps = [r["mAP"] for r in rows if "mAP" in r]
    require(len(losses) == 1 and len(maps) == 1
            and all(map(math.isfinite, losses + maps)),
            f"gf_fsb --bf16: loss {losses}, mAP {maps}")
    print(f"  epoch loss {losses[0]:.4f}, eval mAP@0.25 {maps[0]:.4f}")
    return launches


def gate_phase(tmp, counters):
    """Score the JAX package's trained checkpoint on the card: regenerate
    the 100-scan shapefix val with the port's own modules (as
    ``tools/parity_fixture.py --kind shapefix --val_scans 100 --val_seed
    33`` does), read the msgpack checkpoint with the port's reader, and
    run ``evaluate.main`` over 3 subsample seeds at N=20000 with subset
    FPS over 8192 candidates. Fails unless each IoU's 3-seed mean mAP
    lies within the JAX package's spread of its mean."""
    from backtoreality_tpu_torch.datagen.shapefix import write_shapefix_val
    from backtoreality_tpu_torch.train import evaluate

    val = pathlib.Path(tmp) / "shapefix_bigval"
    t0 = time.perf_counter()
    write_shapefix_val(val, num_scans=100, seed=33)
    print(f"[checkpoint gate] shapefix val of 100 scans regenerated in"
          f" {time.perf_counter() - t0:.1f} s")
    reset(counters)
    t0 = time.perf_counter()
    results = evaluate.main([
        "--model", "votenet", "--checkpoint_path",
        str(ROOT / GATE_CHECKPOINT), "--data_root", str(val), "--split",
        "all", "--num_point", "20000", "--num_target", "256",
        "--batch_size", "8", "--eval_seeds", "3", "--fps_candidates", "8192",
        "--device", "cuda"])
    secs = time.perf_counter() - t0
    check_counts("checkpoint gate", read_counts(counters), "plain",
                 3 * math.ceil(100 / 8), 0)
    print(f"[checkpoint gate] subset FPS 8192: evaluate.main, 3 seeds over"
          f" 100 scans, in {secs:.1f} s")
    gate_check("checkpoint gate", results, GATE, 1)
    return val


def gate_check(label, results, table, band):
    """Each IoU's 3-seed mean mAP against the JAX package's mean: within
    `band` times its spread, the seeds printed side by side."""
    failed = []
    for t, (mean, spread, seeds) in table.items():
        got = results[("", t)]
        card = [r["mAP"] for r in got["seeds"]]
        allowed = band * spread
        within = abs(got["mAP"] - mean) <= allowed
        jax_seeds = " / ".join(f"{v:.4f}" for v in seeds)
        print(f"  mAP@{t}: card {got['mAP']:.4f} (seeds "
              + " / ".join(f"{v:.4f}" for v in card)
              + f"), JAX package {mean:.4f} +/- {spread} (seeds"
              f" {jax_seeds}): {'within' if within else 'OUTSIDE'}"
              f" {band} x the spread ({allowed:.4f})")
        if not within:
            failed.append(f"mAP@{t} {got['mAP']:.4f} not within"
                          f" {allowed:.4f} of {mean}")
    require(not failed, f"{label}: " + "; ".join(failed))


def gate_t2_phase(val, tmp, counters):
    """Score the JAX package's bfloat16 checkpoint lad_t2 on the card as
    the JAX package did (``s2_ladder_bigval.sh``): ``evaluate.main --bf16
    --f32_tail 2`` after 20 batches of BN recalibration on the shapefix
    train split (the port's ``write_shapefix_train``), over 3 subsample
    seeds of the 100-scan val of `gate_phase`. Fails unless each IoU's
    mean lies within GATE_T2_BAND spreads of the JAX package's."""
    from backtoreality_tpu_torch.datagen.shapefix import write_shapefix_train
    from backtoreality_tpu_torch.train import evaluate

    root = pathlib.Path(tmp) / "shapefix_recal"
    t0 = time.perf_counter()
    train, _ = write_shapefix_train(root)
    print(f"[checkpoint gate lad_t2] shapefix train {len(train)} scans"
          f" written in {time.perf_counter() - t0:.1f} s")
    reset(counters)
    t0 = time.perf_counter()
    results = evaluate.main([
        "--model", "votenet", "--checkpoint_path",
        str(ROOT / GATE_T2_CHECKPOINT), "--bf16", "--f32_tail", "2",
        "--train_data_root", str(root / "train"), "--recal_split", "all",
        "--data_root", str(val), "--split", "all", "--num_point", "20000",
        "--num_target", "256", "--batch_size", "8", "--eval_seeds", "3",
        "--fps_candidates", "8192", "--device", "cuda"])
    secs = time.perf_counter() - t0
    check_counts("checkpoint gate lad_t2", read_counts(counters), "plain",
                 RECAL_BATCHES + 3 * math.ceil(100 / 8), 0)
    print(f"[checkpoint gate lad_t2] --bf16 --f32_tail 2, {RECAL_BATCHES}"
          f" recalibration batches, 3 seeds over 100 scans, in {secs:.1f}"
          " s")
    gate_check("checkpoint gate lad_t2", results, GATE_T2, GATE_T2_BAND)


def gf_flags():
    """GroupFree3D's flags at their CLI defaults."""
    from backtoreality_tpu_torch.train import groupfree

    return groupfree.add_flags(argparse.ArgumentParser()).parse_args([])


def gf_first_batch(scans, cfg, use_height, augment=False,
                   center_jitter=0.0):
    """The first B scans of the GroupFree3D fixture at N_GF points, with
    GF's labels, as tensors on the card."""
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.train.common import to_device

    ds = DetectionDataset(cfg, scans, split="all", num_points=N_GF,
                          use_height=use_height, augment=augment,
                          center_jitter=center_jitter, gf_labels=True)
    return to_device(next(iter(DetectionDataLoader(
        ds, B, shuffle=False, prefetch=0))), "cuda")


def gf_kernel_phase(scans, cfg, fps, bq, grouping):
    """The kernels at GroupFree3D's new shapes, with the inputs its forward
    (B=8, N=50000, its CLI defaults) gives them. SA1 on N=50000 rows: FPS
    bit-exact in every layout; the ball query in every tile; the grouping,
    unfused and fused with the localize step, bit-exact forward and
    gradients within the tolerance, for C = 3 (the CLI default) and C = 3 +
    1 (with ``--use_height``). The CenterRefine graph's jitter head: the
    ball query (N=1024 sa2 points, the fixture's 64 GT centres a scene,
    the unused ones padded at +1000; S=16, r=0.8) in every tile, and the
    fused grouping over the 288-wide fp2 features (C = 3 + 288, the
    coordinates divided by the radius), its backward timed for the
    features' gradient. SA2-SA4 run at VoteNet's shapes. Returns the
    records: FPS, ball query (SA1, jitter head), grouping forward, fused
    forward (SA1 C = 3 and 4, jitter head), fused backward (jitter head)."""
    import torch

    from backtoreality_tpu_torch.train import groupfree

    torch.manual_seed(0)
    model = groupfree.build_model(gf_flags(), cfg).cuda().eval()
    batch = gf_first_batch(scans, cfg, use_height=True)
    pc = batch["point_clouds"]
    xyz, height = pc[..., 0:3], pc[..., 3:]
    with torch.inference_mode():
        ep = model(xyz)  # the CLI default: no height feature
    ctr = ep["sa1_xyz"]
    torch.cuda.synchronize()
    del model
    print(f"[kernels: GroupFree3D SA1] B={B} N={N_GF}, centres from the GF"
          " forward")
    fps_rec = check_fps("gf_sa1", xyz, 2048, fps, reps=3, others=True,
                        want_cluster=True)
    bq_rec = check_bq("gf_sa1", xyz, ctr, 0.2, 64, bq, reps=5)
    fps_rec["paths"] = bq_rec["paths"] = GF_PATHS
    group_recs, local_recs = [], []
    for label, feats in (("gf_sa1", None), ("gf_sa1_height", height)):
        on_paths = GF_PATHS if feats is None else ()
        points = xyz if feats is None else pc
        fwd, bwd = check_group(label, points.contiguous(), ctr, 0.2, 64, bq,
                               grouping, reps=10)
        fwd["paths"], bwd["paths"] = on_paths, ()
        group_recs.append(fwd)
        # SA1's input needs no gradient on the paths: the gradients are
        # checked, not timed
        fwd, _ = check_localize(label, xyz, feats, ctr, 0.2, 64, bq,
                                grouping, reps=10)
        fwd["paths"] = on_paths
        local_recs.append(fwd)

    # the jitter head (GroupFreeDetectorDAJitter.ctjt_head): the GT centres
    # of the scenes, most of them padding that hits no point, in the fp2
    # features at the sa2 positions; the local coordinates divided by 0.8
    centres = batch["center_label"]
    padded = (centres.abs() > 500).any(-1).float().mean().item()
    print(f"[kernels: GroupFree3D jitter head] B={B}, {centres.shape[1]} GT"
          f" centres a scene ({padded:.3f} of them padding at +1000),"
          f" sa2 and fp2 from the GF forward, C = 3 + 288")
    ctjt = ("gf_ctjt", ep["sa2_xyz"], ep["fp2_features"], centres, 0.8, 16)
    ctjt_bq = check_bq(*ctjt[:2], *ctjt[3:], bq, reps=5)
    ctjt_fwd, ctjt_bwd = check_localize(*ctjt, bq, grouping, reps=10,
                                        needs=("features",))
    ctjt_bq["paths"] = ctjt_fwd["paths"] = ctjt_bwd["paths"] = GF_JITTER_PATH
    del ep

    # a rank's rows (gf_fsb's data-parallel path): SA1 on the first B / 2
    h = B // 2
    print(f"[kernels: GroupFree3D SA1, a rank's rows] B={h}")
    rank_recs = [check_fps("gf_sa1_rank", xyz[:h], 2048, fps, reps=3),
                 check_bq("gf_sa1_rank", xyz[:h], ctr[:h], 0.2, 64, bq,
                          reps=3)]
    # SA1's input needs no gradient: the backward is checked, not kept
    fwd, _ = check_group("gf_sa1_rank", xyz[:h].contiguous(), ctr[:h], 0.2,
                         64, bq, grouping, reps=5)
    local, _ = check_localize("gf_sa1_rank", xyz[:h], None, ctr[:h], 0.2, 64,
                              bq, grouping, reps=5)
    for rec in rank_recs + [fwd, local]:
        rec["paths"] = ("dp_gf_fsb",)
    return ([fps_rec, rank_recs[0]], [bq_rec, ctjt_bq, rank_recs[1]],
            group_recs + [fwd], local_recs + [ctjt_fwd, local], [ctjt_bwd])


def gf_serving_phase(scans, tmp, cfg, counters, header):
    """``evaluate --model groupfree`` over the GF fixture at the CLI
    defaults (B=8, N=50000, 6 decoder layers, 256 queries) with random
    seeded weights the port saved; the launch counts, finite mAP; then
    the forward's time per batch, scenes/s, peak memory, device time by
    kernel and busy share. Returns the launches."""
    import torch

    from backtoreality_tpu_torch.train import evaluate, groupfree

    torch.manual_seed(0)
    model = groupfree.build_model(gf_flags(), cfg)
    ckpt = pathlib.Path(tmp) / "groupfree.pt"
    torch.save(model.state_dict(), ckpt)
    reset(counters)
    t0 = time.perf_counter()
    results = evaluate.main([
        "--model", "groupfree", "--checkpoint_path", str(ckpt),
        "--data_root", str(scans), "--split", "all", "--batch_size", str(B),
        "--device", "cuda"])
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    batches = math.ceil(NUM_SCANS / B)
    print(f"[serving path: GroupFree3D] evaluate.main --model groupfree over"
          f" {NUM_SCANS} scans in {secs:.1f} s; launches {launches} over"
          f" {batches} batches")
    check_counts("gf_serving", launches, "gf", batches, 0)
    for (prefix, t), metrics in results.items():
        require(math.isfinite(metrics["mAP"]) and math.isfinite(
            metrics["AR"]), f"GF serving: non-finite mAP @ {t}")
        print(f"  [{prefix}] mAP@{t} {metrics['mAP']:.4f}  AR@{t}"
              f" {metrics['AR']:.4f}")

    model.cuda().eval()
    pc = gf_first_batch(scans, cfg, use_height=False)["point_clouds"]
    with torch.inference_mode():
        out = model(pc)
        require(out["last_center"].shape == (B, 256, 3)
                and bool(torch.isfinite(out["last_center"]).all()),
                "GF forward output not finite or of the wrong shape")
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = cuda_ms(lambda: model(pc), reps=10, warmup=2)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        print(f"[forward] GroupFree3D B={B} N={N_GF}: {fwd_ms:.3f} ms per"
              f" batch (median of 10), {B / fwd_ms * 1e3:.1f} scenes/s, peak"
              f" {peak_gb:.2f} GiB  | {header}")
        dev_ms = profile_steps(lambda: model(pc), "GF forwards")
        print(f"  device busy {dev_ms / fwd_ms:.3f} of the unprofiled"
              f" forward ({dev_ms:.3f} of {fwd_ms:.3f} ms)")
    return launches


def gf_train_phase(scans, tmp, cfg, counters, header):
    """``gf_fsb.main`` and ``gf_wsb.main`` at the CLI defaults, one epoch
    (2 steps) and one evaluation each, the launch counts checked per
    recipe, the FSB checkpoint scored by ``evaluate --model groupfree``;
    then the GF FSB train step on a fixed batch (B=8, N=50000): wall,
    phases, kernels' device time, peak memory, busy share, what the
    determinism switch costs, and the FSB and WSB steps gated on bitwise
    repeatability. Returns the launches by recipe and the step's
    numbers."""
    import torch

    from backtoreality_tpu_torch.losses import groupfree as gf_losses
    from backtoreality_tpu_torch.train import (common, evaluate, gf_fsb,
                                               gf_wsb, groupfree)

    tmp = pathlib.Path(tmp)
    steps = NUM_SCANS // B
    launches = {}
    for recipe, entry in (("gf_fsb", gf_fsb), ("gf_wsb", gf_wsb)):
        log = tmp / f"{recipe}_log"
        reset(counters)
        t0 = time.perf_counter()
        entry.main(["--data_root", str(scans), "--train_split", "all",
                    "--val_split", "all", "--log_dir", str(log), "--device",
                    "cuda", "--batch_size", str(B), "--max_epoch", "1",
                    "--val_freq", "1"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[recipe] = read_counts(counters)
        print(f"[training path: {recipe}] {recipe}.main: {steps} steps + one"
              f" evaluation in {secs:.1f} s; launches {launches[recipe]}")
        check_counts(recipe, launches[recipe], "gf",
                     steps + math.ceil(NUM_SCANS / B), steps)
        rows = [json.loads(line) for line in
                (log / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in rows if "loss" in r]
        maps = [r["mAP"] for r in rows if "mAP" in r]
        require(len(losses) == 1 and len(maps) == 1
                and all(map(math.isfinite, losses + maps)),
                f"{recipe}: loss {losses}, mAP {maps}")
        print(f"  epoch loss {losses[0]:.4f}, eval mAP@0.25 {maps[0]:.4f}")
    results = evaluate.main([
        "--model", "groupfree", "--checkpoint_path",
        str(tmp / "gf_fsb_log/ckpt_epoch_last.tar"), "--data_root",
        str(scans), "--split", "all", "--batch_size", str(B), "--device",
        "cuda"])
    require(all(math.isfinite(m["mAP"]) for m in results.values()),
            "evaluate --model groupfree on the trained checkpoint:"
            " non-finite mAP")

    flags = gf_flags()
    torch.manual_seed(0)
    model = groupfree.build_model(flags, cfg).cuda()
    opt = common.make_gf_optimizer(
        model, common.make_gf_schedule(flags.learning_rate, flags, steps),
        common.make_gf_schedule(flags.decoder_learning_rate, flags, steps),
        flags.weight_decay, flags.clip_norm)
    loss_kw = groupfree.loss_kwargs(flags)
    step = groupfree.make_train_step(model, opt, gf_losses.get_loss, cfg,
                                     loss_kw)
    batch = gf_first_batch(scans, cfg, use_height=False, augment=True)
    bnm = flags.bn_momentum
    for _ in range(2):
        step(batch, bnm)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(batch, bnm), reps=10, warmup=0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    aux = step(batch, bnm)
    require(math.isfinite(aux["loss"].item()), "GF step loss not finite")
    print(f"[train step] GroupFree3D FSB B={B} N={N_GF} (CLI defaults: 6"
          f" decoder layers, 256 queries, AdamW, clip 0.1, BN momentum"
          f" {bnm}): {step_ms:.3f} ms per step (median of 10 after 2"
          f" warm-ups), {B / step_ms * 1e3:.1f} scenes/s, peak"
          f" {peak_gb:.2f} GiB, loss {aux['loss'].item():.4f}  | {header}")
    phases = step_phases(
        model, opt,
        lambda eps: gf_losses.get_loss(eps[0], cfg, **loss_kw)[0], [batch],
        bnm)
    print("  phases (median of 5, CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in phases.items()))
    dev_ms = profile_steps(lambda: step(batch, bnm), "GF train steps")
    print(f"  device busy {dev_ms / step_ms:.3f} of the unprofiled step"
          f" ({dev_ms:.3f} of {step_ms:.3f} ms)")
    determinism_cost("GroupFree3D FSB step", lambda: step(batch, bnm),
                     fill=True)

    # bitwise determinism of a whole step, the dropout draws seeded alike
    check_determinism("GroupFree3D FSB", model, opt,
                      lambda: step(batch, bnm))
    wsb_batch = gf_first_batch(scans, cfg, use_height=False, augment=True,
                               center_jitter=0.1)
    wsb_step = groupfree.make_train_step(model, opt, gf_losses.get_loss_weak,
                                         cfg, loss_kw)
    check_determinism("GroupFree3D WSB", model, opt,
                      lambda: wsb_step(wsb_batch, bnm))
    return launches, dict(ms=step_ms, device_ms=dev_ms, peak_gb=peak_gb)


# what `partial_restore` logs grafting a BR checkpoint into the CenterRefine
# graph at the CLI defaults (parameters, then running statistics): the
# JAX package's counts, which tests/test_torch_gf_da.py pins on the CPU
GF_GRAFT_LINES = ["partial restore: copied 432 leaves, kept 8 fresh",
                  "partial restore: copied 96 leaves, kept 4 fresh"]


def gf_graft_fresh(cfg):
    """The entries of the CenterRefine graph at the CLI defaults that a BR
    checkpoint does not hold: those the graft keeps fresh."""
    from backtoreality_tpu_torch.train import groupfree

    flags = gf_flags()
    br = groupfree.build_model(flags, cfg, "da").state_dict()
    cr = groupfree.build_model(flags, cfg, "da_jitter").state_dict()
    return [k for k in cr if k not in br]


def gf_da_phase(scans, virtual, tmp, cfg, counters, header):
    """``gf_br.main`` and ``gf_br_center_refine.main`` at the CLI defaults
    (B=8 source + 8 target scenes, N=50000, 6 decoder layers), one epoch
    of 2 steps and one evaluation each, the GF fixture as the target and a
    virtual fixture as the source; the launch counts per recipe; BR's
    checkpoint grafted into CenterRefine (its log's partial-restore
    counts checked), the CenterRefine checkpoint scored by ``evaluate
    --model groupfree``. Then each DA step on one fixed pair of batches
    (epoch 30 for the label refinement): wall (median of 10 CUDA-event
    timings after 2 warm-ups), scenes/s, peak memory, phases, kernels'
    device time and busy share, what the determinism switch costs, and
    bitwise repeatability (gated). Returns the launches by recipe."""
    import torch

    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.losses import groupfree as gf_losses
    from backtoreality_tpu_torch.train import (common, evaluate, gf_br,
                                               gf_br_center_refine, groupfree)

    tmp = pathlib.Path(tmp)
    steps = NUM_SCANS // B  # one epoch; both fixtures hold NUM_SCANS scans
    evals = math.ceil(NUM_SCANS / B)
    fresh = gf_graft_fresh(cfg)
    require(fresh and all(k.startswith(("ctjt_head.", "jitter_net."))
                          for k in fresh),
            f"GF graft: entries kept fresh outside the jitter head: {fresh}")
    launches = {}
    for recipe, entry, kind in (("gf_br", gf_br, "gf_da"),
                                ("gf_br_center_refine", gf_br_center_refine,
                                 "gf_da_jitter")):
        log = tmp / f"{recipe}_log"
        args = ["--data_root", str(scans), "--source_data_root",
                str(virtual), "--train_split", "all", "--val_split", "all",
                "--log_dir", str(log), "--device", "cuda", "--batch_size",
                str(B), "--max_epoch", "1", "--val_freq", "1"]
        if kind == "gf_da_jitter":
            args += ["--checkpoint_path",
                     str(tmp / "gf_br_log/ckpt_epoch_last.tar")]
        reset(counters)
        t0 = time.perf_counter()
        entry.main(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[recipe] = read_counts(counters)
        print(f"[training path: {recipe}] {recipe}.main: {steps} steps of"
              f" {B} + {B} scenes + one evaluation in {secs:.1f} s;"
              f" launches {launches[recipe]}")
        check_counts(recipe, launches[recipe], kind, 2 * steps + evals,
                     steps)
        rows = [json.loads(line) for line in
                (log / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in rows if "loss" in r]
        maps = [r["mAP"] for r in rows if "mAP" in r]
        evals_logged = (log / "Eval_mAP.txt").read_text().splitlines()
        require(len(losses) == 1 and len(maps) == 1 and len(evals_logged)
                == 1 and all(map(math.isfinite, losses + maps)),
                f"{recipe}: loss {losses}, mAP {maps}, Eval_mAP.txt"
                f" {evals_logged}")
        print(f"  epoch loss {losses[0]:.4f} (da_loss"
              f" {rows[0]['da_loss']:.4f}), eval mAP@0.25 {maps[0]:.4f}")
        if kind == "gf_da_jitter":
            restores = [line.split("] ", 1)[1] for line in
                        (log / "log_train.txt").read_text().splitlines()
                        if "partial restore" in line]
            require(restores == GF_GRAFT_LINES,
                    f"GF BR -> CenterRefine graft: {restores}, expected"
                    f" {GF_GRAFT_LINES}")
            print("  BR grafted into CenterRefine: params "
                  + "; running statistics ".join(restores)
                  + f" (the fresh ones: the jitter head's {len(fresh)})")
    results = evaluate.main([
        "--model", "groupfree", "--checkpoint_path",
        str(tmp / "gf_br_center_refine_log/ckpt_epoch_last.tar"),
        "--data_root", str(scans), "--split", "all", "--batch_size", str(B),
        "--device", "cuda"])
    require(all(math.isfinite(m["mAP"]) for m in results.values()),
            "evaluate --model groupfree on the CenterRefine checkpoint:"
            " non-finite mAP")

    def first_batch(root, split):
        ds = DetectionDataset(cfg, root, split=split, num_points=N_GF,
                              use_height=False, augment=True,
                              center_jitter=0.1, gf_labels=True)
        return common.to_device(next(iter(DetectionDataLoader(
            ds, B, shuffle=False, prefetch=0))), "cuda")

    # as `groupfree._make_datasets`: both domains jittered
    batches = [first_batch(virtual, "train_aug"), first_batch(scans, "all")]
    flags = gf_flags()
    loss_kw = groupfree.loss_kwargs(flags)
    bnm = flags.bn_momentum
    epoch = 30
    for recipe, kind in (("br", "da"), ("br_center_refine", "da_jitter")):
        jitter = kind == "da_jitter"
        torch.manual_seed(0)
        model = groupfree.build_model(flags, cfg, kind).cuda()
        opt = common.make_gf_optimizer(
            model, common.make_gf_schedule(flags.learning_rate, flags, steps),
            common.make_gf_schedule(flags.decoder_learning_rate, flags,
                                    steps), flags.weight_decay,
            flags.clip_norm)
        step = groupfree.make_da_train_step(model, opt, cfg, loss_kw,
                                            jitter=jitter)

        def run():
            return step(*batches, bnm, epoch)

        for _ in range(2):
            run()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, reps=10, warmup=0)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        aux = run()
        require(math.isfinite(aux["loss"].item()),
                f"GF {recipe} step loss not finite")
        print(f"[da step] GroupFree3D {recipe} B={B}+{B} N={N_GF} (CLI"
              f" defaults: 6 decoder layers, 256 queries, AdamW, clip 0.1,"
              f" BN momentum {bnm}; epoch {epoch}): {ms:.3f} ms per step"
              f" (median of 10 after 2 warm-ups), {2 * B / ms * 1e3:.1f}"
              f" scenes/s, peak {peak_gb:.2f} GiB, loss"
              f" {aux['loss'].item():.4f}  | {header}")

        def loss_fn(eps):
            if jitter:
                return gf_losses.get_loss_DA_jitter(*eps, epoch, cfg,
                                                    **loss_kw)[0]
            return gf_losses.get_loss_DA(*eps, cfg, **loss_kw)[0]

        phases = step_phases(model, opt, loss_fn, batches, bnm, jitter)
        print("  phases (median of 5, CUDA events): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in phases.items()))
        dev_ms = profile_steps(run, f"GF {recipe} steps")
        print(f"  device busy {dev_ms / ms:.3f} of the unprofiled step"
              f" ({dev_ms:.3f} of {ms:.3f} ms)")
        determinism_cost(f"GroupFree3D {recipe} step", run)
        check_determinism(f"GroupFree3D {recipe}", model, opt, run)
        del model, opt, step
    return launches


def gf_learning_check(tmp, counters):
    """GF FSB through ``gf_fsb.main`` on the shapefix train split (40
    scans; its 12-scan val), at the JAX package's shapefix run's
    configuration, for 50 epochs of 5 steps and the in-loop evaluation at
    epoch 49; each epoch's loss beside the JAX run's. Fails unless the
    mean loss over epochs 40-49 lies within LEARN_BAND of the JAX run's
    and mAP@0.25 at epoch 49 reaches LEARN_MIN_MAP."""
    import statistics as stats

    from backtoreality_tpu_torch.datagen.shapefix import write_shapefix_train
    from backtoreality_tpu_torch.train import gf_fsb

    root = pathlib.Path(tmp) / "shapefix"
    t0 = time.perf_counter()
    train, val = write_shapefix_train(root)
    print(f"[learning check] shapefix train {len(train)} scans, val"
          f" {len(val)}, written in {time.perf_counter() - t0:.1f} s")
    log = root / "log"
    reset(counters)
    t0 = time.perf_counter()
    gf_fsb.main([
        "--data_root", str(root / "train"), "--val_data_root",
        str(root / "val"), "--train_split", "all", "--val_split", "all",
        "--log_dir", str(log), "--device", "cuda", "--batch_size", str(B),
        "--num_point", "20000", "--use_height", "--num_decoder_layers", "6",
        "--num_target", "256", "--fps_candidates", "8192",
        "--lr_decay_epochs", "210", "260", "--max_epoch", str(LEARN_EPOCHS),
        "--val_freq", str(LEARN_EPOCHS)])
    secs = time.perf_counter() - t0
    steps = LEARN_EPOCHS * (len(train) // B)
    check_counts("learning check", read_counts(counters), "gf",
                 steps + math.ceil(len(val) / B), steps)
    rows = [json.loads(line) for line in
            (log / "metrics.jsonl").read_text().splitlines()]
    card = {r["step"]: r["loss"] for r in rows if "loss" in r}
    ref_rows = [json.loads(line) for line in
                (ROOT / LEARN_METRICS).read_text().splitlines()]
    ref = {r["step"]: r["loss"] for r in ref_rows if "loss" in r}
    ref_map = next(r["mAP"] for r in ref_rows
                   if r.get("kind") == "eval" and r["step"] == 49)
    require(sorted(card) == list(range(LEARN_EPOCHS))
            and all(map(math.isfinite, card.values())),
            f"learning check: epoch losses {card}")
    print(f"[learning check] gf_fsb.main, {steps} steps + the evaluation in"
          f" {secs:.1f} s; loss by epoch, card / JAX package (ratio):")
    for e in range(LEARN_EPOCHS):
        print(f"  epoch {e:2d}: {card[e]:.4f} / {ref[e]:.4f}"
              f" ({card[e] / ref[e]:.3f})")
    late = range(max(LEARN_EPOCHS - 10, 0), LEARN_EPOCHS)
    mean_card = stats.mean(card[e] for e in late)
    mean_ref = stats.mean(ref[e] for e in late)
    ratio = mean_card / mean_ref
    ev = next(r for r in rows if r.get("kind") == "eval")
    print(f"  mean loss over epochs {late.start}-{late.stop - 1}: card"
          f" {mean_card:.4f}, JAX package {mean_ref:.4f}, ratio {ratio:.3f}"
          f" (allowed {LEARN_BAND[0]}-{LEARN_BAND[1]})")
    print(f"  epoch 49 mAP@0.25: card {ev['mAP@0.25']:.4f}, JAX package"
          f" {ref_map:.4f} (at least {LEARN_MIN_MAP}); mAP@0.5: card"
          f" {ev['mAP@0.5']:.4f}, JAX package {LEARN_JAX_MAP50}")
    require(LEARN_BAND[0] <= ratio <= LEARN_BAND[1],
            f"learning check: late loss ratio {ratio:.3f} outside"
            f" {LEARN_BAND}")
    require(ev["mAP@0.25"] >= LEARN_MIN_MAP,
            f"learning check: mAP@0.25 {ev['mAP@0.25']:.4f} below"
            f" {LEARN_MIN_MAP}")
    return dict(seconds=secs, ratio=ratio, map25=ev["mAP@0.25"],
                map50=ev["mAP@0.5"])


# ---------------------------------------------------------------------------
# --query_mode exact: the reference's first-k query, reference checkpoints
# imported, and the round-5 system-parity pairs
# ---------------------------------------------------------------------------

# the exact query at the card against the CPU: a centre may differ only
# where, at its first differing slot, one of the two indices lies within
# this share of r^2 from the radius (the expanded form's f32 products round
# differently in the card's and the CPU's matrix products)
EXACT_GAP_REL = 1e-5
REF_INITS = {"wsb": "votenet", "br": "votenet_da", "gf": "groupfree"}
# the imported GroupFree3D init's widths (evidence/round5/gf/ours_config.json)
GF_INIT_FLAGS = ["--num_decoder_layers", "2", "--dim_feedforward", "128",
                 "--use_height"]
# the round-5 system-parity pairs (evidence/round5/queue/s1_wsb_ours.sh,
# s3_br_ours.sh, s4_cr_ours.sh, s8_gf_ours.sh): fixture kind, entry point,
# flags, the
# imported init it starts from (CenterRefine from scratch, as the JAX leg
# did: its reference init is not in the repo), epochs run. WSB and GF run
# the first 51 of their 125: neither schedule reads --max_epoch (WSB decays
# its rate at 80/120 and BN every 20 epochs, GF steps at 280/340)
PAIR_BR_FLAGS = ["--num_point", "1500", "--num_target", "16",
                 "--batch_size", "8", "--eval_freq", "10", "--seed", "0",
                 "--query_mode", "exact", "--guard_every_steps", "0"]
PAIRS = {
    "wsb": ("parity", "votenet_wsb", [
        "--num_point", "2500", "--num_target", "32", "--batch_size", "8",
        "--eval_freq", "25", "--seed", "0", "--query_mode", "exact",
        "--guard_every_steps", "0"], "wsb", 51),
    "br": ("br", "votenet_br", PAIR_BR_FLAGS + ["--center_jitter", "0.1"],
           "br", 30),
    "cr": ("br", "votenet_br_center_refine",
           PAIR_BR_FLAGS + ["--center_jitter", "0.5"], None, 30),
    "gf": ("parity", "gf_fsb", [
        "--num_point", "2500", "--num_target", "32", "--batch_size", "8",
        *GF_INIT_FLAGS, "--val_freq", "25", "--rng_seed", "0",
        "--query_mode", "exact", "--guard_every_steps", "0"], "gf", 51),
}
PAIR_LATE = 11  # the late ratio's epochs: the last 11 matched
PAIR_BAND = (0.85, 1.15)
# flags whose values differ from the JAX leg's by design: paths, the span,
# the start (the JAX legs of BR and GF started fresh; CenterRefine's second
# segment resumed)
PAIR_OWN_FLAGS = {"data_root", "val_data_root", "source_data_root",
                  "log_dir", "checkpoint_path", "max_epoch", "resume",
                  "device"}


def exact_query_phase(calls, bq, header):
    """The plain exact ball query (``ops.ball_query``, first k in index
    order) on the card against the same call on the CPU at each shape of
    `calls` (label, xyz, centres, radius, nsample): equal except at points
    within EXACT_GAP_REL of r^2 from the radius, whose centres are
    counted; its time (CUDA events) beside K3's at the same shape and
    beside its bound (the distance tests this data needs, as K3's), and
    the peak memory of one call. Returns the records."""
    import torch

    print(f"[exact query] ops.ball_query on the card against the CPU; K3"
          f" (the stratified kernel) at the same shape  | {header}")
    records = []
    for label, xyz, ctr, radius, nsample in calls:
        b, n, _ = xyz.shape
        m = ctr.shape[1]
        want = bq.ball_query(xyz.cpu(), ctr.cpu(), radius, nsample)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = bq.ball_query(xyz, ctr, radius, nsample)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        got = got.cpu()
        require(got.dtype == torch.int32 and got.shape == want.shape,
                f"exact query {label}: {got.dtype} {tuple(got.shape)}")
        rows = (got != want).any(-1).nonzero(as_tuple=True)
        gap_rel = 0.0
        if rows[0].numel():
            first = (got[rows] != want[rows]).int().argmax(-1)
            pts = xyz.cpu().double()
            ctrs = ctr.cpu()[rows].double()
            r2 = radius * radius
            gaps = []
            for idx in (got[rows], want[rows]):
                j = idx.gather(1, first[:, None])[:, 0].long()
                d2 = ((pts[rows[0], j] - ctrs) ** 2).sum(-1)
                gaps.append((d2 - r2).abs() / r2)
            gap = torch.minimum(*gaps)
            gap_rel = gap.max().item()
            require(gap_rel <= EXACT_GAP_REL,
                    f"exact query {label}: a centre differs {gap_rel:.2e}"
                    f" r^2 from the radius, beyond {EXACT_GAP_REL}")
        # tests this data needs: each centre scans up to its last slot's
        # hit, or every point where it has fewer hits than slots (its
        # real hits rise strictly; fill slots repeat the first)
        full = want[..., -1] > want[..., -2]
        tests = torch.where(full, want[..., -1].long() + 1, n).sum().item()
        bnd, by = bound_ms(BQ_OPS_PER_TEST * tests,
                           b * n * 12 + b * m * 12 + b * m * nsample * 4)
        exact_ms = cuda_ms(lambda: bq.ball_query(xyz, ctr, radius, nsample),
                           reps=5, ahead=True)
        k3_ms = cuda_ms(lambda: bq._ball_query_stratified_cuda(
            xyz, ctr, radius, nsample), reps=5, ahead=True)
        rec = dict(shape=label, b=b, n=n, m=m, nsample=nsample,
                   radius=radius, boundary_centres=int(rows[0].numel()),
                   max_gap_rel=gap_rel, ms=exact_ms, k3_ms=k3_ms,
                   tests_needed=tests, bound_ms=bnd, bound_by=by,
                   peak_mib=peak)
        records.append(rec)
        print(f"  {label:9s} B={b} N={n} M={m} S={nsample} r={radius}:"
              f" equal but {rec['boundary_centres']} centres at the radius"
              f" (max {gap_rel:.2e} r^2); exact {exact_ms:.3f} ms, K3"
              f" {k3_ms:.4f} ms ({exact_ms / k3_ms:.1f}x), bound"
              f" {bnd:.4f} ms ({by}, {tests} tests needed), peak"
              f" {peak:.1f} MiB")
    return records


def torch_import_phase(tmp):
    """The reference's initial checkpoints in the repo, gunzipped and
    converted by the port's ``tools.torch_import`` CLI; each loads into its
    graph through ``restore_weights`` with no entry left fresh (it refuses
    otherwise). Returns {name: converted path}."""
    import gzip

    from backtoreality_tpu_torch.tools import torch_import
    from backtoreality_tpu_torch.train import common, evaluate, groupfree

    from backtoreality_tpu_torch.data import get_config

    cfg = get_config("scannet_md40")
    out = {}
    for name, model in REF_INITS.items():
        src = pathlib.Path(tmp) / f"ref_{name}.tar"
        with gzip.open(ROOT / "evidence/round5" / name
                       / "ref_init_checkpoint.tar.gz") as f:
            src.write_bytes(f.read())
        out[name] = pathlib.Path(tmp) / f"ref_{name}.pt"
        leaves, epoch = torch_import.main([str(src), "--model", model,
                                           "--out", str(out[name])])
        if model == "groupfree":
            flags = groupfree.add_flags(argparse.ArgumentParser()).parse_args(
                GF_INIT_FLAGS)
            graph = groupfree.build_model(flags, cfg)
        else:
            flags = evaluate.add_common_flags(
                argparse.ArgumentParser()).parse_args([])
            graph = evaluate.build_model(flags, cfg, "plain" if model ==
                                         "votenet" else "da")
        log = []
        common.restore_weights(graph, out[name], model, log=log.append)
        entries = len(graph.state_dict())
        print(f"[torch_import] {name} ({model}): {leaves} parameter tensors,"
              f" epoch {epoch}; {entries} entries restored, none fresh: "
              + "; ".join(line for line in log if "partial" in line))
    return out


def check_exact_counts(label, launches, fps_per_forward, forwards):
    """Launches on an exact-mode path: FPS `fps_per_forward` a forward, no
    stratified ball query and no stratified grouping (the exact query and
    the gather are plain PyTorch)."""
    want = {k: 0 for k in launches}
    want["fps"] = fps_per_forward * forwards
    for name, n in want.items():
        require(launches[name] == n,
                f"{label}: {name} launched {launches[name]} times, expected"
                f" {n} ({forwards} forwards in exact mode)")


def exact_serving_phase(scans, gf_scans, inits, cfg, counters, header):
    """``evaluate --query_mode exact`` on the imported reference inits:
    VoteNet (WSB's) at the CLI defaults (B=8, N=40000, FPS over the full
    cloud) on the 16 VoteNet scans, GroupFree3D (GF's, at its widths:
    2 decoder layers, feed-forward 128, height) at N=50000 on the 16 GF
    scans; launch counts (FPS 5 and 4 a forward, K3 and K4 none), finite
    mAP, then a batch's forward timed (CUDA events), peak memory. Returns
    the launches by path."""
    import torch

    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.train import evaluate, groupfree

    batches = math.ceil(NUM_SCANS / B)
    launches = {}
    for path, model_flag, ckpt, root, extra, fps_per_forward in (
            ("serving_exact", "votenet", inits["wsb"], scans,
             ["--num_point", str(N)], 5),
            ("gf_serving_exact", "groupfree", inits["gf"], gf_scans,
             GF_INIT_FLAGS, 4)):
        args = ["--model", model_flag, "--checkpoint_path", str(ckpt),
                "--query_mode", "exact", "--data_root", str(root), "--split",
                "all", "--batch_size", str(B), "--device", "cuda", *extra]
        reset(counters)
        t0 = time.perf_counter()
        results = evaluate.main(args)
        secs = time.perf_counter() - t0
        launches[path] = read_counts(counters)
        print(f"[serving path: {model_flag} exact] evaluate.main --query_mode"
              f" exact over {NUM_SCANS} scans in {secs:.1f} s; launches"
              f" {launches[path]} over {batches} batches")
        check_exact_counts(path, launches[path], fps_per_forward, batches)
        for (prefix, t), metrics in results.items():
            require(math.isfinite(metrics["mAP"]) and math.isfinite(
                metrics["AR"]), f"{path}: non-finite mAP @ {t}")
            print(f"  [{prefix or 'votenet'}] mAP@{t} {metrics['mAP']:.4f}"
                  f"  AR@{t} {metrics['AR']:.4f}")
        # a batch's forward, timed, with the same weights (both inits take
        # the height feature)
        sub = argparse.ArgumentParser()
        if model_flag == "votenet":
            flags = evaluate.add_common_flags(sub).parse_args(
                ["--query_mode", "exact"])
            model = evaluate.build_model(flags, cfg)
            n, key = N, "center"
        else:
            flags = groupfree.add_flags(sub).parse_args(
                [*GF_INIT_FLAGS, "--query_mode", "exact"])
            model = groupfree.build_model(flags, cfg)
            n, key = N_GF, "last_center"
        model.load_state_dict(torch.load(ckpt, weights_only=True))
        model.cuda().eval()
        ds = DetectionDataset(cfg, root, split="all", num_points=n,
                              use_height=True,
                              gf_labels=model_flag == "groupfree")
        pc = torch.from_numpy(next(iter(DetectionDataLoader(
            ds, B, shuffle=False, prefetch=0)))["point_clouds"]).cuda()
        with torch.inference_mode():
            out = model(pc)
            require(out[key].shape[:2] == (B, flags.num_target)
                    and bool(torch.isfinite(out[key]).all()),
                    f"{path}: forward output not finite or misshapen")
            torch.cuda.reset_peak_memory_stats()
            fwd_ms = cuda_ms(lambda: model(pc), reps=10, warmup=2)
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
        print(f"[forward] {model_flag} exact B={B} N={n}: {fwd_ms:.3f} ms per"
              f" batch (median of 10), {B / fwd_ms * 1e3:.1f} scenes/s, peak"
              f" {peak_gb:.2f} GiB  | {header}")
        del model, out
    return launches


def _jsonl(path):
    return [json.loads(line) for line in
            pathlib.Path(path).read_text().splitlines() if line.strip()]


def _no_obj_dir(parent, prefix):
    """A new directory under `parent` whose path holds no ``obj``: the
    dataset reads a path with ``obj`` as virtual data, which draws its
    centre jitter from another table (the JAX legs' fixtures were under
    /tmp/parity and /tmp/br)."""
    while True:
        path = pathlib.Path(tempfile.mkdtemp(dir=parent, prefix=prefix))
        if "obj" not in str(path):
            return path


def parity_pairs_phase(tmp, inits, counters, header):
    """The round-5 system-parity pairs run by the port on the card: the
    ``parity`` and ``br`` fixtures written by the port's
    ``tools.parity_fixture``, then each recipe's ``main`` with the JAX
    leg's flags (checked against ``ours_config.json``), from the imported
    reference init where PAIRS names one; ``tools.parity_report`` against
    the reference loop's history; the late ratio (the port's mean train
    loss over the last PAIR_LATE matched epochs over the reference's
    there) beside the JAX leg's, gated on PAIR_BAND; the mAP rows beside
    the reference's and the JAX leg's (not gated: 12 val scans). Returns
    the launches by pair."""
    import io
    import shutil
    from contextlib import redirect_stdout

    import torch

    from backtoreality_tpu_torch.tools import parity_fixture, parity_report

    root = _no_obj_dir(tmp, "pairs_")
    fixtures = {}
    for kind in ("parity", "br"):
        t0 = time.perf_counter()
        parts = parity_fixture.write_fixture(kind, root / kind)
        fixtures[kind] = {p.name: p for p in parts}
        print(f"[parity pairs] fixture {kind}: "
              + ", ".join(f"{p.name} {len(list(p.glob('*_vert.npy')))}"
                          for p in parts)
              + f" scans in {time.perf_counter() - t0:.1f} s")
    launches = {}
    for pair, (kind, entry, flags, init, epochs) in PAIRS.items():
        ev = ROOT / "evidence/round5" / pair
        fx = fixtures[kind]
        log = root / f"{pair}_log"
        args = ["--data_root", str(fx["train" if kind == "parity" else
                                       "real"]),
                "--val_data_root", str(fx["val"]), "--train_split", "all",
                "--val_split", "all", *flags, "--max_epoch", str(epochs),
                "--log_dir", str(log), "--device", "cuda"]
        if kind == "br":
            args += ["--source_data_root", str(fx["virtual"])]
        if init:
            args += ["--checkpoint_path", str(inits[init])]
        module = importlib.import_module(
            f"backtoreality_tpu_torch.train.{entry}")
        reset(counters)
        t0 = time.perf_counter()
        module.main(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[f"pair_{pair}"] = got = read_counts(counters)
        # the JAX leg's flags, but for paths, span and start
        mine = json.loads((log / "config.json").read_text())
        theirs = json.loads((ev / "ours_config.json").read_text())
        differ = {k: (mine[k], theirs[k]) for k in mine
                  if k in theirs and k not in PAIR_OWN_FLAGS
                  and mine[k] != theirs[k]}
        require(not differ, f"pair {pair}: flags differ from the JAX leg's"
                            f" {differ}")
        unported = sorted(k for k in theirs if k not in mine)
        steps = epochs * (40 // B)
        evals = epochs // (mine.get("eval_freq") or mine["val_freq"])
        fwd = (2 * steps if kind == "br" else steps) + evals * math.ceil(
            12 / B)
        check_exact_counts(f"pair {pair}", got,
                           4 if pair == "gf" else 5, fwd)
        # the reference loop's history and the JAX leg's metrics, as the
        # report reads them
        ref_dir, jax_dir = root / f"{pair}_ref", root / f"{pair}_jax"
        ref_dir.mkdir()
        jax_dir.mkdir()
        shutil.copy(ev / "ref_history.jsonl", ref_dir / "history.jsonl")
        shutil.copy(ev / "ours_metrics.jsonl", jax_dir / "metrics.jsonl")
        buf = io.StringIO()
        with redirect_stdout(buf):
            report = parity_report.main(["--ref_dir", str(ref_dir),
                                         "--ours_dir", str(log)])
        jax_report = parity_report.build_report(str(ref_dir), str(jax_dir))
        rows = report["loss"]
        require(len(rows) == epochs and all(
            math.isfinite(r["ours_loss"]) for r in rows),
            f"pair {pair}: {len(rows)} matched epochs of {epochs}")
        late = rows[-PAIR_LATE:]
        epochs_late = [r["epoch"] for r in late]
        ratio = (sum(r["ours_loss"] for r in late)
                 / sum(r["ref_loss"] for r in late))
        jax_rows = {r["epoch"]: r for r in jax_report["loss"]}
        jax_same = (sum(jax_rows[e]["ours_loss"] for e in epochs_late)
                    / sum(jax_rows[e]["ref_loss"] for e in epochs_late))
        jax_tail = jax_report["loss"][-PAIR_LATE:]
        jax_own = (sum(r["ours_loss"] for r in jax_tail)
                   / sum(r["ref_loss"] for r in jax_tail))
        per_epoch = [r["ours_loss"] / r["ref_loss"] for r in rows]
        start = f"the imported {init} init" if init else "scratch"
        print(f"[parity pair: {pair}] {entry}.main, {epochs} epochs of"
              f" {40 // B} steps from {start} in {secs:.1f} s; launches"
              f" {got}; JAX-leg flags not in the port: {unported}")
        print("  matched epochs, port / reference loop (parity_report):")
        print("    " + buf.getvalue().rstrip().replace("\n", "\n    "))
        print(f"  late ratio (epochs {epochs_late[0]}-{epochs_late[-1]}):"
              f" port {ratio:.3f}, JAX leg {jax_same:.3f} over the same"
              f" epochs, {jax_own:.3f} over its own last {PAIR_LATE}"
              f" (epochs {jax_tail[0]['epoch']}-{jax_tail[-1]['epoch']});"
              f" port's per-epoch ratios {min(per_epoch):.3f}-"
              f"{max(per_epoch):.3f}  | {header}")
        jax_map = {r["step"]: r["mAP"] for r in _jsonl(jax_dir /
                                                        "metrics.jsonl")
                   if r.get("kind") == "eval"}
        for r in report["eval"]:
            print(f"  epoch {r['epoch']} mAP@0.25: port {r['ours_mAP']:.4f},"
                  f" reference {r['ref_mAP']:.4f}, JAX leg"
                  f" {jax_map.get(r['epoch'], float('nan')):.4f}")
        require(PAIR_BAND[0] <= ratio <= PAIR_BAND[1],
                f"pair {pair}: late ratio {ratio:.3f} outside {PAIR_BAND}")
    return launches


# ---------------------------------------------------------------------------
# Data parallelism, the preemption guard and the profiler window
# ---------------------------------------------------------------------------

DP_WORLD = 2
# f32 on the card, only the order of the sums differs (the BN moments'
# and the gradients' over the ranks). That order moves some ReLU masks
# and max-pool winners that lie within rounding of a tie, and each flip
# moves a whole term of a gradient that at init is a sum of many terms of
# both signs: world 1 against itself on the rows in reverse parts the
# gradients by about 1% (PERF.md, section 6). So the step is compared
# twice. As it runs: the loss, all gradients as one vector and all BN
# buffers as one, each relative to its norm, within DP_TOL or DP_NOISE
# times that reversal's error. With the choices pinned (Pinned: world
# 1's replayed in world 2 and in the reversal): every tensor within DP_TOL
# of its largest magnitude, or DP_NOISE times the reversal's error of that
# tensor where rounding alone parts it further (dp_pinned_error)
DP_TOL = 1e-4
DP_NOISE = 4
DP_TIMEOUT = 600  # seconds for a pair of ranks or of trainer processes
DP_CASES = (("votenet_fsb", "plain", 1), ("votenet_br", "da", 2),
            ("gf_fsb", "gf", 1))


class Pinned:
    """The discrete choices of a train step, recorded in one run and
    replayed in another: every ReLU's mask (``torch.relu``), every
    max-pool's winner over a group's samples (``torch.amax`` over axis 2
    of a (B, M, S, C) tensor), every SA layer's ball query (its slots and
    hit flags), GroupFree3D's top-k queries and every ``nn_distance``
    nearest neighbour of the criteria. A choice whose inputs lie within
    rounding of a tie (a pre-activation at 0, two samples' features, two
    distances, a point at the radius) flips when the order of a sum
    changes, and each flip moves a whole term of the gradient; the ball
    query's tile, and with it how a distance at the radius rounds, also
    follows the rows of a launch (``ops/ball_query.py``: 4 rows may take
    another tile than 8). Replayed, two runs part by rounding alone. Recording computes the replay's
    function (a mask product, a gather at the winner), so the two runs are
    the same function. Rows are the first axis of every choice: a replay
    takes the recorded rows in reverse (`reverse`) and, on a tensor with
    fewer rows than recorded, this rank's share of them (a rank's forward;
    a criterion sees the gathered global batch)."""

    def __init__(self, log=None):
        self.log = [] if log is None else log
        self.kinds = []
        self.recording = log is None
        self.reverse = False
        self.k = 0

    def _choice(self, make, rows, kind):
        import torch

        if self.recording:
            choice = make()
            self.log.append(choice)
            self.kinds.append(kind)
            return choice
        choice = self.log[self.k]
        self.k += 1
        if not torch.is_tensor(choice):  # a packed mask
            import numpy as np

            shape, bits = choice
            choice = torch.from_numpy(np.unpackbits(
                bits, count=math.prod(shape)).reshape(shape).astype(bool))
        if self.reverse:
            choice = choice.flip(0)
        if rows < choice.shape[0]:
            from backtoreality_tpu_torch import parallel

            r = parallel.rank()
            choice = choice[r * rows:(r + 1) * rows]
        return choice

    def _relu(self, x):
        mask = self._choice(lambda: x.detach() > 0, x.shape[0],
                            "ReLU masks")
        require(mask.shape == x.shape, f"replayed mask {tuple(mask.shape)}"
                f" for a ReLU on {tuple(x.shape)}")
        return x * mask.to(x.device)

    def _amax(self, x, dim, keepdim=False):
        if x.dim() != 4 or dim != 2:
            return self.real["amax"](x, dim, keepdim)
        win = self._choice(lambda: x.detach().argmax(2, keepdim=True),
                           x.shape[0], "max-pool winners").to(x.device)
        out = x.gather(2, win)
        return out if keepdim else out.squeeze(2)

    def _ball_query(self, xyz, centres, radius, nsample, return_hit=False):
        made = []

        def query():
            made.extend(self.real["ball_query"](xyz, centres, radius,
                                                nsample, return_hit=True))
            return made[0]

        idx = self._choice(query, xyz.shape[0], "ball-query slots")
        hit = self._choice(lambda: made[1], xyz.shape[0], "ball-query hits")
        idx, hit = idx.to(xyz.device), hit.to(xyz.device)
        return (idx, hit) if return_hit else idx

    def _top_k(self, scores, k):
        return self._choice(lambda: self.real["top_k"](scores, k),
                            scores.shape[0], "top-k queries").to(
                                scores.device)

    def _nn_distance(self, pc1, pc2, l1smooth=False, l1=False, delta=1.0):
        from backtoreality_tpu_torch.ops import huber_loss

        # the pairwise distances as ops/chamfer.py forms them
        diff = pc1[:, :, None, :] - pc2[:, None, :, :]
        if l1smooth:
            d = huber_loss(diff, delta).sum(-1)
        elif l1:
            d = diff.abs().sum(-1)
        else:
            d = (diff * diff).sum(-1)
        i1 = self._choice(lambda: d.detach().argmin(2, keepdim=True),
                          d.shape[0], "nearest neighbours").to(d.device)
        i2 = self._choice(lambda: d.detach().argmin(1, keepdim=True),
                          d.shape[0], "nearest neighbours").to(d.device)
        return (d.gather(2, i1)[..., 0], i1[..., 0].int(),
                d.gather(1, i2)[:, 0], i2[:, 0].int())

    def _sites(self):
        import torch

        from backtoreality_tpu_torch import ops
        from backtoreality_tpu_torch.losses import groupfree as gf_losses
        from backtoreality_tpu_torch.losses import votenet as vote_losses
        from backtoreality_tpu_torch.models.groupfree import detector

        return ((torch, "relu", self._relu), (torch, "amax", self._amax),
                (ops, "ball_query_stratified", self._ball_query),
                (detector, "top_k_indices", self._top_k),
                (vote_losses, "nn_distance", self._nn_distance),
                (gf_losses, "nn_distance", self._nn_distance))

    def __enter__(self):
        self.k = 0
        self.real, self.saved = {}, []
        for module, attr, fn in self._sites():
            self.saved.append((module, attr, getattr(module, attr)))
            setattr(module, attr, fn)
        self.real = {"amax": self.saved[1][2],
                     "ball_query": self.saved[2][2],
                     "top_k": self.saved[3][2]}
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)
        if not exc[0]:
            require(self.recording or self.k == len(self.log),
                    f"{self.k} of {len(self.log)} recorded choices replayed")
        self.recording = False

    def differ(self, recording):
        """{kind: (choices that differ, choices)}: `recording`'s own
        choices against this log's as a replay would take them for it."""
        out = {}
        self.k = 0
        for kind, own in zip(recording.kinds, recording.log):
            mine = self._choice(None, own.shape[0], kind).to(own.device)
            n = out.setdefault(kind, [0, 0])
            n[0] += (mine != own).sum().item()
            n[1] += own.numel()
        self.k = 0
        return {kind: tuple(n) for kind, n in out.items()}

    def packed(self):
        """The log on the host, each mask packed to bits."""
        import numpy as np
        import torch

        return [(tuple(c.shape), np.packbits(c.cpu().numpy()))
                if c.dtype == torch.bool else c.cpu() for c in self.log]


def dp_batches(spec, cfg):
    """The global batches of the data-parallel cases (host numpy, the
    first B scans of each fixture, as the bench-config steps take them):
    VoteNet FSB, BR's source and target, GroupFree3D FSB."""
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader

    def first(root, split, **kw):
        ds = DetectionDataset(cfg, root, split=split, augment=True, **kw)
        return next(iter(DetectionDataLoader(ds, B, shuffle=False,
                                             prefetch=0)))

    votenet = dict(num_points=N, use_height=True)
    return {"votenet_fsb": [first(spec["scans"], "all", **votenet)],
            "votenet_br": [first(spec["virtual"], "train_aug", **votenet),
                           first(spec["scans"], "all", center_jitter=0.1,
                                 **votenet)],
            "gf_fsb": [first(spec["gf_scans"], "all", num_points=N_GF,
                             use_height=False, gf_labels=True)]}


def dp_steps(spec, counters, pinned=None):
    """Each data-parallel case's train step from a common seeded state on
    this rank's rows of its global batch (all of it without a process
    group), twice from that state: the loss, the gradients (summed over
    the ranks; GF's clipped), the BN buffers, whether the two runs agree
    bitwise, the launches of the first run, then the step's time (median
    of 3 CUDA-event runs) and peak memory. Then the step with its discrete
    choices pinned (:class:`Pinned`): without a process group recorded,
    then replayed on the rows in reverse, with the packed log under
    "choices"; in a group replayed from `pinned` (name -> packed log).
    Under "flips", the choices that the rows in reverse (in a group: this
    rank's rows) make otherwise than the recording."""
    import copy

    import torch

    from backtoreality_tpu_torch import parallel
    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.losses import groupfree as gf_losses
    from backtoreality_tpu_torch.train import common, groupfree, votenet

    cfg = get_config("scannet_md40")
    batches = dp_batches(spec, cfg)
    flags = votenet.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--fps_candidates", "8192"])
    out = {}
    for name, kind, _ in DP_CASES:
        torch.manual_seed(0)
        if name == "gf_fsb":
            gflags = gf_flags()
            gflags.transformer_dropout = 0.0
            model = groupfree.build_model(gflags, cfg).cuda()
            opt = common.make_gf_optimizer(
                model, common.make_gf_schedule(gflags.learning_rate, gflags,
                                               2),
                common.make_gf_schedule(gflags.decoder_learning_rate, gflags,
                                        2),
                gflags.weight_decay, gflags.clip_norm)
            step = groupfree.make_train_step(
                model, opt, gf_losses.get_loss, cfg,
                groupfree.loss_kwargs(gflags))
            args = (gflags.bn_momentum,)
        else:
            model = votenet.build_model(flags, cfg, kind).cuda()
            with torch.no_grad():
                # the votes' offsets zeroed: vote FPS and vote grouping then
                # read exact coordinates, so their choices cannot flip on
                # the f32 rounding by which two reduction orders move a
                # vote (about 1e-5 m; a flipped proposal changes the step)
                model.vgen.out.weight[:3] = 0
                model.vgen.out.bias[:3] = 0
            opt = common.make_optimizer(model.parameters(), "adam", lr0=1e-3)
            if kind == "da":
                step = votenet.make_da_train_step(model, opt, cfg)
                args = (0.5, 0)
            else:
                step = votenet.make_train_step(model, opt,
                                               vote_losses.get_loss, cfg)
                args = (0.5,)
        rows = [common.to_device(parallel.shard_rows(b)[0], "cuda")
                for b in batches[name]]
        state = copy.deepcopy(model.state_dict())
        opt_state = copy.deepcopy(opt.state_dict())

        def run(batch_rows=rows):
            model.load_state_dict(state)
            opt.load_state_dict(copy.deepcopy(opt_state))
            return step(*batch_rows, *args)

        def take(batch_rows):
            aux = run(batch_rows)
            return dict(
                loss=aux["loss"].detach().cpu(),
                grads={n: p.grad.detach().cpu()
                       for n, p in model.named_parameters()
                       if p.grad is not None},
                buffers={n: b.detach().cpu()
                         for n, b in model.named_buffers()})

        reset(counters)
        first = take(rows)
        launches = read_counts(counters)
        again = take(rows)
        same = (torch.equal(first["loss"], again["loss"]) and all(
            torch.equal(first[part][k], again[part][k])
            for part in ("grads", "buffers") for k in first[part]))
        if parallel.world() == 1:
            # the rows in reverse order: the same step but for the order
            # of the sums, which sets how far f32 lets two orders part
            reverse = [common.to_device({k: v[::-1].copy()
                                         for k, v in b.items()}, "cuda")
                       for b in batches[name]]
            first["reversed"] = take(reverse)
            pin, own = Pinned(), Pinned()
            with pin:
                first["pinned"] = take(rows)
            with own:  # the reversed rows' own choices
                take(reverse)
            pin.reverse = True
            first["flips"] = pin.differ(own)
            del own
            with pin:
                first["pinned_reversed"] = take(reverse)
            first["choices"] = pin.packed()
            del pin, reverse
        else:
            pin, own = Pinned(pinned[name]), Pinned()
            with own:  # this rank's own choices
                take(rows)
            first["flips"] = pin.differ(own)
            del own
            with pin:
                first["pinned"] = take(rows)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, reps=3, warmup=0)
        out[name] = dict(first, repeat_equal=same, launches=launches,
                         ms=ms, peak_gb=torch.cuda.max_memory_allocated()
                         / 2**30, rows=len(rows[0]["point_clouds"]))
        del model, opt, step, rows
        torch.cuda.empty_cache()
    return out


def dp_rank(rank, world, address, spec, out_dir):
    """One rank of the world-2 check: both ranks on the one card, over
    gloo (the stated rule: local ranks that share a card)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from backtoreality_tpu_torch import parallel
    from backtoreality_tpu_torch.ops import fps, grouping
    from backtoreality_tpu_torch.train.common import make_deterministic

    # the module: the package exports its exact query under the same name
    ball_query = importlib.import_module(
        "backtoreality_tpu_torch.ops.ball_query")

    make_deterministic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    name = parallel.init(rank, world, address, device, world)
    try:
        require(name == "gloo", f"two ranks on one card over {name}")
        counters = (fps.KERNEL, ball_query.KERNEL, grouping.KERNEL,
                    grouping.LOCALIZE)
        out_dir = pathlib.Path(out_dir)
        choices = torch.load(out_dir / "dp_choices.pt", weights_only=False)
        torch.save(dp_steps(spec, counters, choices),
                   out_dir / f"dp_rank{rank}.pt")
    finally:
        parallel.shutdown()


def dp_error(one, two):
    """Errors of `two` against `one`: the loss's, all gradients' as one
    vector and all BN buffers' as one, each relative to its norm; and the
    worst single tensor (relative to its largest magnitude) with its
    name."""
    import torch

    require(set(two["grads"]) == set(one["grads"]),
            "the gradients' names differ")

    def rel(part):
        keys = sorted(one[part])
        a = torch.cat([two[part][k].double().flatten() for k in keys])
        b = torch.cat([one[part][k].double().flatten() for k in keys])
        return ((a - b).norm() / b.norm()).item()

    worst = max(((two[part][k] - v).abs().max().item()
                 / max(v.abs().max().item(), 1e-30), f"{part} {k}")
                for part in ("grads", "buffers")
                for k, v in one[part].items())
    return dict(loss=(abs(two["loss"] - one["loss"])
                      / abs(one["loss"])).item(),
                grads=rel("grads"), buffers=rel("buffers"),
                worst=worst)


def dp_pinned_error(one, two, noise):
    """Per tensor (the loss, each gradient, each BN buffer) the error of
    `two` against `one` relative to the tensor's largest magnitude, and
    its bound: DP_TOL, or DP_NOISE times the same error of `noise` (world
    1 on the rows in reverse) where rounding alone parts that tensor by
    more (a gradient that is zero but for rounding, such as an attention
    key's bias). Returns {name: (error, bound)}."""
    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    out = {"loss": (rel(two["loss"], one["loss"]),
                    max(DP_TOL, DP_NOISE * rel(noise["loss"], one["loss"])))}
    for part in ("grads", "buffers"):
        for k, v in one[part].items():
            out[f"{part} {k}"] = (rel(two[part][k], v), max(
                DP_TOL, DP_NOISE * rel(noise[part][k], v)))
    return out


def _launch_pair(module, args, cwd):
    """Two processes of `module` with `args`, ranks 0 and 1 of a group of
    two on this host (the BTR_* variables): both on the one card, which
    BTR_LOCAL_PROCESSES states, so the group runs over gloo."""
    import os

    from backtoreality_tpu_torch import parallel

    port = parallel.free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, BTR_COORDINATOR=f"127.0.0.1:{port}",
                   BTR_NUM_PROCESSES="2", BTR_PROCESS_ID=str(r),
                   BTR_LOCAL_PROCESSES="2", PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"backtoreality_tpu_torch.train.{module}",
             *args], env=env, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, timeout=DP_TIMEOUT):
    """Every process's (exit code, output) within `timeout` seconds; all
    are killed at it."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               0.0))
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _epoch_losses(text):
    import re

    return {int(m.group(1)): float(m.group(2)) for m in
            re.finditer(r"epoch (\d+) .*?loss ([\d.]+)", text)}


def dp_contract(module, args, log, cwd, epochs):
    """The JAX package's two-process contract (tests/test_multiprocess.py)
    for `module` at --multihost world 2 on the card: both ranks exit 0 and
    log the same loss every epoch, one set of checkpoints (rank 0's), the
    rank-1 log, and an evaluation in both logs. Returns its seconds."""
    t0 = time.perf_counter()
    for rc, out in _wait(_launch_pair(module, args + ["--multihost"], cwd)):
        require(rc == 0, f"{module} --multihost: a rank exited {rc}:\n"
                f"{out[-3000:]}")
    secs = time.perf_counter() - t0
    log0 = (log / "log_train.txt").read_text()
    rank1 = log / "log_train.txt.rank1"
    require(rank1.exists(), f"{module}: no log_train.txt.rank1")
    log1 = rank1.read_text()
    l0, l1 = _epoch_losses(log0), _epoch_losses(log1)
    require(sorted(l0) == list(epochs) and l0 == l1,
            f"{module}: the ranks' epoch losses {l0} and {l1}")
    require("eval" in log0 and "eval" in log1 and "mAP" in log1,
            f"{module}: an evaluation is missing from a rank's log")
    leftovers = sorted(p.name for p in log.glob("*.tmp"))
    require(not leftovers, f"{module}: half-written files {leftovers}")
    print(f"[data parallel] {module} --multihost, 2 processes on the card"
          f" (gloo), batch {args[args.index('--batch_size') + 1]} a"
          f" process: epochs {sorted(l0)} in {secs:.1f} s, losses {l0} on"
          f" both ranks, checkpoints"
          f" {sorted(p.name for p in log.glob('*.tar'))}, rank-1 log and"
          f" per-rank evaluation present")
    return secs


def dp_compare(one, two, header):
    """The world-2 steps (`two`, one dict a rank) against world 1's
    (`one`): both ranks bitwise equal, each step bitwise repeatable, the
    step as it runs and the step with its choices pinned within their
    bounds (DP_TOL, DP_NOISE), the launches a rank; prints the errors and
    the step times. Returns the launches (rank 0) by path."""
    import torch

    paths = {}
    for name, kind, forwards in DP_CASES:
        a, b = two[0][name], two[1][name]
        same = torch.equal(a["loss"], b["loss"]) and all(
            torch.equal(a[part][k], b[part][k])
            for part in ("grads", "buffers") for k in a[part])
        require(same, f"{name}: the ranks hold different losses, gradients"
                " or buffers")
        require(one[name]["repeat_equal"] and a["repeat_equal"]
                and b["repeat_equal"],
                f"{name}: a step is not bitwise repeatable")
        err = dp_error(one[name], a)
        noise = dp_error(one[name], one[name]["reversed"])
        for part in ("loss", "grads", "buffers"):
            bound = max(DP_TOL, DP_NOISE * noise[part])
            require(err[part] <= bound, f"{name}: world 2 against world 1:"
                    f" {part} off by {err[part]:.3g}, beyond {bound:.3g}")
        # the choices pinned: every tensor within DP_TOL of its largest
        # magnitude, or DP_NOISE times what rounding alone gives it
        pinned = dp_pinned_error(one[name]["pinned"], a["pinned"],
                                 one[name]["pinned_reversed"])
        over = {k: v for k, v in pinned.items() if v[0] > v[1]}
        require(not over, f"{name}: world 2 against world 1, choices"
                f" pinned: {len(over)} tensors beyond their bound, e.g."
                f" {sorted(over.items(), key=lambda kv: -kv[1][0])[:5]}")
        require(torch.equal(a["pinned"]["loss"], b["pinned"]["loss"]),
                f"{name}: the ranks' pinned losses differ")
        worst = max(pinned.items(), key=lambda kv: kv[1][0] / kv[1][1])
        loose = {k: v for k, v in pinned.items() if v[1] > DP_TOL}
        for r, rank in enumerate(two):
            check_counts(f"dp {name} rank {r}", rank[name]["launches"],
                         kind, forwards, 1)
        paths[f"dp_{name}"] = a["launches"]
        print(f"[data parallel] {name}: world 2 ({a['rows']} + {b['rows']}"
              f" rows, gloo on one card) against world 1"
              f" ({one[name]['rows']} rows), relative errors: loss"
              f" {err['loss']:.3g}, gradients {err['grads']:.3g}, BN buffers"
              f" {err['buffers']:.3g}, worst tensor {err['worst'][0]:.3g}"
              f" ({err['worst'][1]}); world 1 on the rows reversed: loss"
              f" {noise['loss']:.3g}, gradients {noise['grads']:.3g},"
              f" buffers {noise['buffers']:.3g}, worst tensor"
              f" {noise['worst'][0]:.3g} ({noise['worst'][1]}); both ranks"
              f" bitwise equal; two runs bitwise equal on each; launches a"
              f" rank {a['launches']}")
        pin_err = dp_error(one[name]["pinned"], a["pinned"])
        pin_noise = dp_error(one[name]["pinned"],
                             one[name]["pinned_reversed"])
        for label, run in (("world 1 on the rows reversed", one[name]),
                           ("world 2 on rank 0's rows", a)):
            print(f"[data parallel] {name}: {label} makes other discrete"
                  " choices than world 1: " + ", ".join(
                      f"{n} of {total} {kind}" for kind, (n, total)
                      in run["flips"].items()))
        print(f"[data parallel] {name}, choices pinned (world 1's replayed):"
              f" gradients {pin_err['grads']:.3g} against world 1 (world 1"
              f" reversed {pin_noise['grads']:.3g}); {len(pinned)} tensors"
              f" within their bounds, {len(pinned) - len(loose)} of them"
              f" within {DP_TOL:g} of their largest magnitude; closest to"
              f" its bound {worst[0]} {worst[1][0]:.3g} of {worst[1][1]:.3g};"
              f" bounds by rounding {len(loose)}, median"
              f" {statistics.median([v[1] for v in loose.values()] or [0]):.3g},"
              f" the largest"
              f" {max([v[1] for v in loose.values()], default=0):.3g}"
              f" ({max(loose, key=lambda k: loose[k][1], default='-')})")
        print(f"[data parallel] {name} step: world 1 {one[name]['ms']:.3f}"
              f" ms, peak {one[name]['peak_gb']:.2f} GiB; world 2 rank 0"
              f" {a['ms']:.3f} ms, peak {a['peak_gb']:.2f} GiB, rank 1"
              f" {b['ms']:.3f} ms, peak {b['peak_gb']:.2f} GiB (the two"
              f" ranks share the card)  | {header}")
    return paths

def dp_phase(scans, virtual, gf_scans, tmp, counters, header):
    """``[data parallel]``: world 1 over NCCL bitwise the plain run; the
    world-2 steps against world 1, repeated bitwise, with their launches;
    the multi-process contract of votenet_fsb (and its resume), votenet_br
    and gf_fsb. Returns the world-2 steps' launches (rank 0) by path."""
    import os

    import torch

    from backtoreality_tpu_torch import parallel
    from backtoreality_tpu_torch.train import common, votenet_fsb

    tmp = pathlib.Path(tmp)
    device = torch.device("cuda", 0)
    require(parallel.backend(device, 1) == "nccl"
            and parallel.backend(device, 2) == "gloo",
            "the backend rule: NCCL for a card a rank, gloo when shared")

    # world 1: a group of one over NCCL is the plain run, bit for bit
    args = ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--device", "cuda", "--num_point",
            str(N), "--batch_size", str(B), "--fps_candidates", "8192",
            "--max_epoch", "1", "--eval_freq", "10"]
    runs = {}
    for label, extra in (("plain", []), ("multihost", ["--multihost"])):
        log = tmp / f"dp_world1_{label}"
        if extra:
            os.environ["BTR_NUM_PROCESSES"] = "1"
        try:
            model, _ = votenet_fsb.main(args + ["--log_dir", str(log),
                                                *extra])
        finally:
            os.environ.pop("BTR_NUM_PROCESSES", None)
        losses = [json.loads(line)["loss"] for line in
                  (log / "metrics.jsonl").read_text().splitlines()]
        runs[label] = (losses, {k: v.detach().cpu().clone()
                                for k, v in model.state_dict().items()})
        del model
    require(not torch.distributed.is_initialized(),
            "the world-1 group was not left")
    (l_plain, s_plain), (l_mh, s_mh) = runs["plain"], runs["multihost"]
    differ = [k for k in s_plain if not torch.equal(s_plain[k], s_mh[k])]
    print(f"[data parallel] world 1: votenet_fsb.main --multihost"
          f" (BTR_NUM_PROCESSES=1, NCCL) against the plain run, 2 steps:"
          f" losses {l_mh} and {l_plain}, {len(differ)} of {len(s_plain)}"
          f" state entries differ bitwise")
    require(l_mh == l_plain and not differ,
            f"world 1 over NCCL is not the plain run: {differ[:5]}")
    torch.cuda.empty_cache()

    # world 2 on the one card against world 1, on the same global batches
    spec = dict(scans=str(scans), virtual=str(virtual),
                gf_scans=str(gf_scans))
    one = dp_steps(spec, counters)
    torch.save({name: one[name].pop("choices") for name in one},
               tmp / "dp_choices.pt")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        common.spawn(dp_rank, DP_WORLD, spec, str(tmp), timeout=DP_TIMEOUT)
    except SystemExit as failed:
        require(False, f"the world-2 ranks failed ({failed.code}; 124:"
                f" killed at {DP_TIMEOUT} s)")
    ranks_s = time.perf_counter() - t0
    two = [torch.load(tmp / f"dp_rank{r}.pt", weights_only=False)
           for r in range(DP_WORLD)]
    paths = dp_compare(one, two, header)
    print(f"[data parallel] world-2 ranks: {ranks_s:.1f} s from spawn to"
          " exit")

    # the JAX package's multi-process contract, on the 16-scan fixtures
    per_process = str(B // DP_WORLD)
    vote = ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--num_point", str(N), "--batch_size",
            per_process, "--fps_candidates", "8192"]
    log = tmp / "dp_fsb"
    dp_contract("votenet_fsb", vote + ["--log_dir", str(log), "--max_epoch",
                                       "2", "--eval_freq", "2"],
                log, tmp, range(2))
    require(sorted(p.name for p in log.glob("*.tar")) == ["checkpoint.tar"],
            "votenet_fsb: one checkpoint")
    dp_contract("votenet_fsb", vote + [
        "--log_dir", str(log), "--max_epoch", "3", "--eval_freq", "1",
        "--resume", "--checkpoint_path", str(log / "checkpoint.tar")],
        log, tmp, range(3))
    log = tmp / "dp_br"
    dp_contract("votenet_br", vote + [
        "--log_dir", str(log), "--source_data_root", str(virtual),
        "--max_epoch", "1", "--eval_freq", "1"], log, tmp, range(1))
    require(sorted(p.name for p in log.glob("*.tar")) == ["train_BR.tar"],
            "votenet_br: one checkpoint")
    log = tmp / "dp_gf"
    dp_contract("gf_fsb", [
        "--data_root", str(gf_scans), "--train_split", "all", "--val_split",
        "all", "--batch_size", per_process, "--log_dir", str(log),
        "--max_epoch", "1", "--val_freq", "1"], log, tmp, range(1))
    require(sorted(p.name for p in log.glob("*.tar"))
            == ["ckpt_epoch_0.tar", "ckpt_epoch_last.tar"],
            "gf_fsb: one set of checkpoints")
    return paths


def preemption_phase(scans, gf_scans, tmp, header):
    """``[preemption]``: ``votenet_fsb`` in a process of its own with
    ``--guard_every_steps 1`` (B=8: 2 steps an epoch, 30 epochs), sent
    SIGTERM once its first checkpoint is written: it must exit with 143
    having written the guard's newest snapshot, saved as the last epoch
    it completed (E), after 2E + 2 to 2E + 4 steps (a snapshot after a
    step of epoch E + 1 counts as epoch E: a resume re-runs that epoch);
    its parameters must equal bitwise the state after as many steps
    replayed here (the steps are deterministic); ``--resume`` then re-runs
    epoch E + 1 and finishes. Then the time of one ``guard.update`` for
    VoteNet's and GroupFree3D's state."""
    import os
    import signal

    import torch

    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.losses import groupfree as gf_losses
    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.train import (common, groupfree, votenet,
                                               votenet_fsb)

    tmp = pathlib.Path(tmp)
    log = tmp / "preempt"
    args = ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--device", "cuda", "--num_point", str(N),
            "--batch_size", str(B), "--fps_candidates", "8192",
            "--eval_freq", "100"]
    run = args + ["--log_dir", str(log), "--guard_every_steps", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "backtoreality_tpu_torch.train.votenet_fsb"]
    proc = subprocess.Popen(cmd + run + ["--max_epoch", "30"], env=env,
                            cwd=tmp, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + DP_TIMEOUT
        while not (log / "checkpoint.tar").exists():
            require(proc.poll() is None and time.monotonic() < deadline,
                    "preemption: the trainer ended before its first"
                    " checkpoint")
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
    finally:
        (rc, out), = _wait([proc])
    ckpt = common.load_checkpoint(log / "checkpoint.tar")
    epoch = ckpt["epoch"]
    steps = int(ckpt["optimizer"]["state"][0]["step"].item())
    extra = steps - 2 * (epoch + 1)
    require(rc == 143 and f"SIGTERM: saving checkpoint at epoch {epoch}"
            in out and 0 <= extra <= 2,
            f"preemption: exit {rc}, epoch {epoch}, {steps} steps:"
            f"\n{out[-3000:]}")

    # the state after `steps` steps, replayed in this process: epochs 0..E
    # through the entry point, then the first `extra` steps of epoch E + 1
    model, opt = votenet_fsb.main(args + ["--log_dir", str(tmp / "replay"),
                                          "--max_epoch", str(epoch + 1)])
    if extra:
        cfg = get_config("scannet_md40")
        flags = votenet.add_common_flags(argparse.ArgumentParser()
                                         ).parse_args([
            "--num_point", str(N), "--batch_size", str(B),
            "--fps_candidates", "8192"])
        lr_fn, bn_fn = votenet._schedules(flags)
        common.set_learning_rate(opt, lr_fn(epoch + 1))
        loader = DetectionDataLoader(
            votenet._dataset(flags, cfg, scans, "all", augment=True), B,
            seed=flags.seed, prefetch=0)
        loader.set_epoch(epoch + 1)
        step = votenet.make_train_step(model, opt, vote_losses.get_loss, cfg)
        for _, batch in zip(range(extra), loader):
            step(votenet.to_device(batch, "cuda"), bn_fn(epoch + 1))
    state = model.state_dict()
    differ = [k for k, v in ckpt["model"].items()
              if not torch.equal(v, state[k].cpu())]
    print(f"[preemption] votenet_fsb --guard_every_steps 1, SIGTERM once"
          f" its first checkpoint was written: exit {rc}, the snapshot of"
          f" epoch {epoch} after {steps} steps; {len(differ)} of"
          f" {len(state)} entries differ bitwise from {steps} steps"
          " replayed")
    require(not differ, f"preemption: the checkpoint is not the snapshot:"
            f" {differ[:5]}")
    (rc, out), = _wait([subprocess.Popen(
        cmd + run + ["--max_epoch", str(epoch + 2), "--resume",
                     "--checkpoint_path", str(log / "checkpoint.tar")],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)])
    require(rc == 0 and f"epoch {epoch + 1:03d}" in out
            and common.load_checkpoint(log / "checkpoint.tar")["epoch"]
            == epoch + 1, f"preemption: --resume exited {rc}:\n{out[-3000:]}")
    print(f"[preemption] --resume re-ran epoch {epoch + 1} and finished")

    # one guard.update: VoteNet's state (Adam), GroupFree3D's (AdamW)
    cfg = get_config("scannet_md40")
    gflags = gf_flags()
    torch.manual_seed(0)
    gf = groupfree.build_model(gflags, cfg).cuda()
    gopt = common.make_gf_optimizer(gf, lambda c: 1e-4, lambda c: 1e-5)
    groupfree.make_train_step(gf, gopt, gf_losses.get_loss, cfg,
                              groupfree.loss_kwargs(gflags))(
        gf_first_batch(gf_scans, cfg, use_height=False), gflags.bn_momentum)
    guard = common.PreemptionGuard(tmp / "guard.tar")
    try:
        for label, m, o in (("VoteNet", model, opt), ("GroupFree3D", gf,
                                                      gopt)):
            mb = sum(t.numel() * t.element_size() for t in
                     [*m.state_dict().values(),
                      *(v for s in o.state_dict()["state"].values()
                        for v in s.values() if torch.is_tensor(v))]) / 2**20
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                guard.update(m, o, 0)
                times.append((time.perf_counter() - t0) * 1e3)
            print(f"[preemption] guard.update, {label} model and optimizer"
                  f" ({mb:.1f} MiB): first {times[0]:.2f} ms (pinned"
                  f" buffers allocated), then median"
                  f" {statistics.median(times[1:]):.2f} ms  | {header}")
    finally:
        guard.close()
    del gf, gopt, model, opt
    torch.cuda.empty_cache()


def profile_phase(scans, tmp):
    """``[profile]``: ``votenet_fsb.main --profile_dir D`` for 16 steps (B=2
    on the 16 scans, 2 epochs) writes a Chrome trace of host steps 10-15
    whose kernel events name the FPS, ball-query and grouping kernels."""
    import re

    from backtoreality_tpu_torch.train import votenet_fsb

    tmp = pathlib.Path(tmp)
    trace_dir = tmp / "trace"
    t0 = time.perf_counter()
    votenet_fsb.main([
        "--data_root", str(scans), "--train_split", "all", "--val_split",
        "all", "--log_dir", str(tmp / "profile_log"), "--device", "cuda",
        "--num_point", str(N), "--batch_size", "2", "--fps_candidates",
        "8192", "--max_epoch", "2", "--eval_freq", "10", "--profile_dir",
        str(trace_dir)])
    secs = time.perf_counter() - t0
    path = trace_dir / "trace_rank0.json"
    require(path.exists(), f"[profile] no trace at {path}")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = {k: sorted({m.group(0) for m in (
        re.search(rf"\b{k}\w*kernel", n) for n in kernels) if m})
        for k in ("fps_", "bq_", "group_")}
    mib = path.stat().st_size / 2**20
    print(f"[profile] votenet_fsb.main --profile_dir: 16 steps in"
          f" {secs:.1f} s, trace of steps 10-15 {mib:.1f} MiB,"
          f" {len(events)} events, {len(kernels)} kernel names; ours:"
          f" {found}")
    require(all(found.values()), f"[profile] the trace lacks a kernel:"
            f" {found}")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels_only", action="store_true",
                        help="stop after the kernels' checks and times"
                             " (phases 1 and 2): for comparing two trees"
                             " in one run, not a pass")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from backtoreality_tpu_torch.train.common import make_deterministic

    # as every entry point does, before any CUDA work: the steps timed and
    # checked here are the ones users run
    make_deterministic()
    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.data.synthetic import write_synthetic_scans
    from backtoreality_tpu_torch.ops import _build
    # the module: the package exports its exact query under the same
    # name
    bq = importlib.import_module("backtoreality_tpu_torch.ops.ball_query")
    from backtoreality_tpu_torch.ops import fps
    from backtoreality_tpu_torch.ops import grouping
    from backtoreality_tpu_torch.train import evaluate

    header = card_header()
    print(f"card: {header}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}"
          f" python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    kernels = (fps.KERNEL, bq.KERNEL, grouping.KERNEL)
    counters = kernels + (grouping.LOCALIZE,)

    # each phase's seconds, printed at the end
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all(kernels)
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    lap("build")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    tmp = tempfile.TemporaryDirectory()

    # fixture and seeded checkpoint
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

    # 2. kernels against their plain versions at the main paths' inputs;
    # SA1 FPS runs over the full cloud when serving and over the first
    # 8192 candidates when training, every other call on every path
    print("[kernels] kernel vs plain on the card (median of CUDA events)")
    xyz = pc[..., 0:3]
    fps_records = []
    for label, x, npoint in (
            ("sa1", xyz, 2048), ("sa2", ep["sa1_xyz"], 1024),
            ("sa3", ep["sa2_xyz"], 512), ("sa4", ep["sa3_xyz"], 256),
            ("vote_agg", ep["vote_xyz"], 256)):
        rec = check_fps(label, x, npoint, fps, reps=5, others=True,
                        want_cluster=True if label == "sa1" else None)
        rec["paths"] = SERVING if label == "sa1" else ALL_PATHS
        fps_records.append(rec)
    rec = check_fps("candidates8192", xyz, 2048, fps, reps=5,
                    candidates=8192, others=True, want_cluster=True)
    rec["paths"] = TRAINING
    fps_records.append(rec)
    for label, x, npoint, want_cluster in fps_edge_clouds(xyz, device):
        fps_records.append(check_fps(label, x, npoint, fps, reps=1,
                                     want_cluster=want_cluster))
        if label == "padded":
            require(bool((fps.furthest_point_sample(x, 64)[1] == 0).all()),
                    "fps: an all-padding row must give index 0")
    floor = fps_floor(fps, device)

    sa_calls = (
        ("sa1", xyz, pc[..., 3:], ep["sa1_xyz"], 0.2, 64),
        ("sa2", ep["sa1_xyz"], ep["sa1_features"], ep["sa2_xyz"], 0.4, 32),
        ("sa3", ep["sa2_xyz"], ep["sa2_features"], ep["sa3_xyz"], 0.8, 16),
        ("sa4", ep["sa3_xyz"], ep["sa3_features"], ep["sa4_xyz"], 1.2, 16),
        ("vote_agg", ep["vote_xyz"], ep["vote_features"],
         ep["aggregated_vote_xyz"], 0.3, 16))
    # the jitter head's layer (CenterRefine only): the GT centres, padded
    # rows at the origin, in the FP2 features at the sa2 positions; r=0.8
    # for the query, no radius normalization (the fused entry at 1.0)
    centres = torch.from_numpy(batch["center_label"]).to(device)
    ctjt = ("ctjt", ep["sa2_xyz"], ep["fp2_features"], centres, 0.8, 16)
    bq_records = []
    for label, x, _, c, r, s in sa_calls:
        rec = check_bq(label, x, c, r, s, bq, reps=5)
        rec["paths"] = ALL_PATHS
        bq_records.append(rec)
    rec = check_bq(*ctjt[:2], *ctjt[3:], bq, reps=5)
    rec["paths"] = JITTER_PATH
    bq_records.append(rec)
    check_bq_edges(bq, device)
    group_fwd, group_bwd, local_fwd, local_bwd = [], [], [], []
    for label, x, feats, c, r, s in sa_calls:
        fwd, bwd = check_group(label, torch.cat([x, feats], -1), c, r, s,
                               bq, grouping, reps=10)
        fwd["paths"] = ALL_PATHS
        # SA1's input (coordinates and height) needs no gradient
        bwd["paths"] = () if label == "sa1" else TRAINING
        group_fwd.append(fwd)
        group_bwd.append(bwd)
        # what the training path differentiates: the features past SA1,
        # and at vote clustering also the votes and the centres drawn
        # from them
        needs = {"sa1": (), "vote_agg": ("xyz", "features", "centres")}.get(
            label, ("features",))
        fwd, bwd = check_localize(label, x, feats, c, r, s, bq, grouping,
                                  reps=10, needs=needs)
        fwd["paths"] = ALL_PATHS
        local_fwd.append(fwd)
        if bwd is not None:
            bwd["paths"] = TRAINING
            local_bwd.append(bwd)
    # the jitter head trains the FP2 features through this layer
    fwd, bwd = check_localize(*ctjt, bq, grouping, reps=10,
                              needs=("features",), scale=1.0)
    fwd["paths"] = bwd["paths"] = JITTER_PATH
    local_fwd.append(fwd)
    local_bwd.append(bwd)
    # the data-parallel paths run each call on a rank's rows, B / 2: the
    # same checks on the first B / 2 rows (GroupFree3D's SA2-SA4 have
    # VoteNet's shapes, its SA1 is checked with the GF kernels)
    h = B // 2
    print(f"[kernels: a rank's rows] B={h}, the first {h} rows of each call")
    rec = check_fps("candidates8192_rank", xyz[:h], 2048, fps, reps=3,
                    candidates=8192)
    rec["paths"] = DP_VOTENET
    fps_records.append(rec)
    for label, x, feats, c, r, s in sa_calls:
        on = DP_VOTENET if label in ("sa1", "vote_agg") else DP_PATHS
        if label != "sa1":
            rec = check_fps(f"{label}_rank", x[:h], c.shape[1], fps, reps=3)
            rec["paths"] = on
            fps_records.append(rec)
        rec = check_bq(f"{label}_rank", x[:h], c[:h], r, s, bq, reps=3)
        rec["paths"] = on
        bq_records.append(rec)
        fwd, bwd = check_group(f"{label}_rank",
                               torch.cat([x[:h], feats[:h]], -1), c[:h], r,
                               s, bq, grouping, reps=5)
        fwd["paths"], bwd["paths"] = on, () if label == "sa1" else on
        group_fwd.append(fwd)
        group_bwd.append(bwd)
        needs = {"sa1": (), "vote_agg": ("xyz", "features", "centres")}.get(
            label, ("features",))
        fwd, bwd = check_localize(f"{label}_rank", x[:h], feats[:h], c[:h],
                                  r, s, bq, grouping, reps=5, needs=needs)
        fwd["paths"] = on
        local_fwd.append(fwd)
        if bwd is not None:
            bwd["paths"] = on
            local_bwd.append(bwd)
    # without features: the coordinates alone
    _, x, _, c, r, s = sa_calls[2]
    check_localize("sa3_xyz_only", x, None, c, r, s, bq, grouping, reps=0)
    check_half_refused(ep["sa1_xyz"], ep["sa1_features"], ep["sa2_xyz"],
                       fps, bq, grouping, counters)
    # the exact query's shapes: those of the five layers
    exact_calls = [(label, x, c, r, s) for label, x, _, c, r, s in sa_calls]
    del ep
    # GroupFree3D's fixture: 8 objects of 5500 points and 8000 floor points,
    # 52000 a scan, so the 50000-point draw takes no point twice
    gf_scans = pathlib.Path(tmp.name) / "gf_scans"
    write_synthetic_scans(gf_scans, cfg, num_scans=NUM_SCANS, seed=2,
                          points_per_object=5500, floor_points=8000)
    gf_fps, gf_bq, gf_group, gf_local, gf_local_bwd = gf_kernel_phase(
        gf_scans, cfg, fps, bq, grouping)
    fps_records += gf_fps
    bq_records += gf_bq
    group_fwd += gf_group
    local_fwd += gf_local
    local_bwd += gf_local_bwd
    lap("kernels")
    if args.kernels_only:
        print(json.dumps({"kernels_only": {
            "fps": fps_records, "fps_floor_us": {
                str(k): v for k, v in floor.items()},
            "ball_query": bq_records, "group_stratified": group_fwd,
            "group_stratified_backward": group_bwd,
            "group_localize_stratified": local_fwd,
            "group_localize_stratified_backward": local_bwd}}))
        return 0

    # 3. the serving path: the evaluation entry point on the card
    reset(counters)
    t0 = time.perf_counter()
    results = evaluate.main(["--model", "votenet", "--checkpoint_path",
                             str(ckpt), "--device", "cuda", *common])
    eval_s = time.perf_counter() - t0
    serving = read_counts(counters)
    batches = math.ceil(NUM_SCANS / B)
    print(f"[serving path] evaluate.main over {NUM_SCANS} scans in"
          f" {eval_s:.1f} s; launches {serving} over {batches} batches")
    check_counts("serving", serving, "plain", batches, 0)
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
        dev_ms = profile_steps(lambda: model(pc), "forwards")
        print(f"  device busy {dev_ms / fwd_ms:.3f} of the unprofiled"
              f" forward")
    del model, out
    lap("votenet serving")

    # 4. the training paths: FSB, then WSB, BR and BR+CenterRefine on a
    # virtual-scene source fixture (scene_aug names under a path holding
    # "obj", as the reference's obj_aug: the dataset draws its jitter
    # table for virtual scans there), the DA steps, and the checkpoint
    # gate
    paths = {"serving": serving}
    paths["training"], fsb_f32 = train_phase(scans, tmp.name, cfg, counters,
                                             header)
    lap("votenet fsb")
    virtual = pathlib.Path(tmp.name) / "obj_aug"
    write_synthetic_scans(virtual, cfg, num_scans=NUM_SCANS, seed=1,
                          prefix="scene_aug", points_per_object=4500,
                          floor_points=8000)
    paths.update(recipe_phase(scans, virtual, tmp.name, counters))
    lap("votenet recipes")
    da_step_phase(scans, virtual, cfg, header)
    lap("votenet da steps")
    paths["training_bf16"] = bf16_phase(scans, tmp.name, cfg, counters,
                                        header, fsb_f32, fps, bq, grouping)
    lap("votenet bf16")
    val = gate_phase(tmp.name, counters)
    lap("checkpoint gate")
    gate_t2_phase(val, tmp.name, counters)
    lap("checkpoint gate lad_t2")

    # 7. GroupFree3D: serving, FSB and WSB, and the learning check
    paths["gf_serving"] = gf_serving_phase(gf_scans, tmp.name, cfg, counters,
                                           header)
    lap("gf serving")
    gf_launches, gf_f32 = gf_train_phase(gf_scans, tmp.name, cfg, counters,
                                         header)
    paths.update(gf_launches)
    lap("gf fsb/wsb")
    paths["gf_fsb_bf16"] = gf_bf16_phase(gf_scans, tmp.name, cfg, counters,
                                         header, gf_f32, bq, grouping)
    lap("gf bf16")
    # the DA recipes' source: 16 virtual scans of 52000 points (scene_aug
    # names under a path holding "obj", as VoteNet's), the GF fixture the
    # target
    gf_virtual = pathlib.Path(tmp.name) / "gf_virtual" / "obj_aug"
    write_synthetic_scans(gf_virtual, cfg, num_scans=NUM_SCANS, seed=3,
                          prefix="scene_aug", points_per_object=5500,
                          floor_points=8000)
    paths.update(gf_da_phase(gf_scans, gf_virtual, tmp.name, cfg, counters,
                             header))
    lap("gf br/center refine")
    gf_learning_check(tmp.name, counters)
    lap("gf learning check")

    # 8. --query_mode exact: the exact query at the layers' shapes (and GF's
    # SA1 at N=50000), the reference's inits imported, both detectors served
    # from them, and the round-5 parity pairs
    gf_xyz = gf_first_batch(gf_scans, cfg, use_height=False)["point_clouds"]
    gf_ctr = grouping.gather_points(gf_xyz, fps.furthest_point_sample(
        gf_xyz, 2048))
    exact_query_phase(exact_calls + [("gf_sa1", gf_xyz, gf_ctr, 0.2, 64)],
                      bq, header)
    lap("exact query")
    inits = torch_import_phase(tmp.name)
    lap("torch_import")
    paths.update(exact_serving_phase(scans, gf_scans, inits, cfg, counters,
                                     header))
    lap("serving exact")
    paths.update(parity_pairs_phase(tmp.name, inits, counters, header))
    lap("parity pairs")

    # 10. data parallelism, the preemption guard and the profiler window
    paths.update(dp_phase(scans, virtual, gf_scans, tmp.name, counters,
                          header))
    lap("data parallel")
    preemption_phase(scans, gf_scans, tmp.name, header)
    lap("preemption")
    profile_phase(scans, tmp.name)
    lap("profile")
    tmp.cleanup()

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    # a kernel's times sum one call at each shape on the FSB training
    # path, as in the earlier slices; the jitter head's shape stands in
    # per_shape, on the br_center_refine path
    main_path = "training"
    kernels_line = [
        summarize("fps", fps.KERNEL, "backtoreality_tpu_torch/csrc/fps.cu",
                  fps_records, by_path("fps"), main_path),
        summarize("ball_query_stratified", bq.KERNEL,
                  "backtoreality_tpu_torch/csrc/ball_query.cu", bq_records,
                  by_path("ball_query"), main_path),
        summarize("group_stratified", grouping.KERNEL,
                  "backtoreality_tpu_torch/csrc/group_stratified.cu",
                  group_fwd, by_path("group_stratified"), main_path),
        summarize("group_stratified_backward", grouping.KERNEL,
                  "backtoreality_tpu_torch/csrc/group_stratified.cu",
                  group_bwd, by_path("group_stratified_backward"),
                  main_path),
        summarize("group_localize_stratified", grouping.LOCALIZE,
                  "backtoreality_tpu_torch/csrc/group_stratified.cu",
                  local_fwd, by_path("group_localize_stratified"),
                  main_path),
        summarize("group_localize_stratified_backward", grouping.LOCALIZE,
                  "backtoreality_tpu_torch/csrc/group_stratified.cu",
                  local_bwd, by_path("group_localize_stratified_backward"),
                  main_path),
    ]
    kernels_line[0]["serial_floor_us"] = {str(k): v
                                          for k, v in floor.items()}
    for k in kernels_line:
        require(all(k["launches_by_path"][p] > 0
                    for p in TRAINING + GF_TRAINING + BF16_TRAINING
                    + DP_PATHS),
                f"{k['name']}: not launched on every training path")
        checked = {p for r in k["per_shape"] for p in r.get("paths", ())}
        require(set(DP_PATHS) <= checked, f"{k['name']}: no check against"
                f" the plain version at {set(DP_PATHS) - checked}'s shapes")
    print("[seconds] " + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
          + f"; total {sum(laps.values()):.1f}")
    print(header)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
