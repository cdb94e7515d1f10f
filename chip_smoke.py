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
   with the length of its longest list. ``[ball query tiles]``: at every
   SA shape of both detectors and at both jitter heads, every tile the
   ball query's plan may pick gives bitwise the same slots and hit flags,
   and so do the first 4 rows alone against the same rows among 8 (a
   row's slots do not depend on the rows of a launch). The data-parallel
   paths' shapes too: every call of VoteNet's training forward and
   GroupFree3D's SA1 on the first 4 of the 8 rows (a rank's share), each
   record tagged with those paths; every kernel must have such a record.
   Every wrapper of K1-K4 raises on bfloat16 and float16 inputs without
   launching. ``[bn_relu]``: the eval-mode BatchNorm and ReLU kernel at
   every (rows, C) that the two serving forwards give it (VoteNet B=8,
   N=40000; GroupFree3D B=32, N=50000: every BatchNorm of both models
   launches it once), on a ragged row count and at C = 288, on inputs
   holding NaN, +-inf and -0, in float32 and (VoteNet's shapes, the edges)
   bfloat16: bitwise the torch sequence (BatchNorm, then torch.relu); each
   shape timed against the plain sequence and its bytes at 3.35 TB/s
   (SA1's of both models, the serving forwards' sums, SA1 in bfloat16).
   Its launches count on every path: BN_PER_FORWARD a forward times the
   path's evaluation forwards, none on a training step.
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
   ``[jitter_diag]`` (after the recipes): ``tools/jitter_diag.py`` on the
   CenterRefine checkpoint and ``config.json`` over its 16 target scans:
   ``objects`` equal to the scans' valid boxes, every field finite, 5 FPS
   and 6 ball queries and fused groupings a batch. ``[cluster sampling
   random]``: ``votenet_fsb.main --cluster_sampling random`` (2 steps and
   an evaluation) twice with one seed and once with another, and
   ``votenet_br.main`` with it: every forward's draws those of
   ``train.common.draw_generator`` at (seed, step) (the DA step's source
   and target at (seed, step, 0) and (seed, step, 1)), every evaluation
   batch's at (0,); the two runs of one seed bitwise equal, the other
   seed's draws other; 4 FPS, 5 ball queries and fused groupings a
   forward, the shapes held (``ShapeLog``).
6. The checkpoint gates: the JAX package's trained checkpoint
   (``evidence/round4/ckpt/lad_f32.tar.gz``) read by the port's msgpack
   reader and scored by ``evaluate.main`` over 3 subsample seeds on the
   100-scan shapefix val; fails unless each IoU's mean mAP lies within
   the JAX package's spread of its mean. Then its bfloat16 checkpoints
   ``lad_t2`` and ``lad_t1`` through ``evaluate --bf16 --f32_tail N``
   (N = 2, 1) after 20 batches of BN recalibration on the shapefix train
   split, as the JAX package scored them; fails unless each mean lies
   within twice the JAX spread, the seeds printed beside the JAX
   package's; then ``lad_t4`` (N = 4), whose band adds the JAX package's
   own shift from its TPU to a CPU (ROADMAP §C.10), both terms printed.
   Every gate's AP matching goes through the native IoU library
   (``eval/native.py``; its calls counted); ``[native eval]`` times
   lad_f32's matching through it and through the Python per-pair loop,
   every class's AP within 1e-9.
   ``[model surface]``: the VoteNet model surface that no recipe runs, at
   B=8, N=40000 (``model_surface_phase``): ``BoxNet`` + ``get_loss_boxnet``
   (2 steps and an eval forward, then its step timed and gated on
   repeatability), ``VoteNetDA`` under ``get_loss_DA_separate`` (one step
   of 8 + 8 scenes), ``VoteNetDAJitter2`` under CenterRefine's criterion
   (2 steps; its head's ball query in every tile and its fused grouping
   at C = 3 + 128 held against the plain versions), a
   ``Pointnet2BackboneCam`` forward, and ``SAModuleMSG``,
   ``SAModuleVotesRlt``, ``LFPModuleMSG`` and ``SAModuleVotes`` with avg
   and rbf pooling and without xyz, each in train mode through the kernels
   and through the plain grouping on the same neighbourhoods (output
   bit-exact, gradients within 1e-5), with their new ball-query and
   grouping shapes checked; the launches of each path against the counts
   read off the code, and every shape each path launched FPS, the ball
   query or the fused grouping at (forward and backward, logged by
   ``ShapeLog``) held by a check against the plain version. ``[mfu]``:
   ``tools/mfu.py`` for VoteNet (B=8, N=40000, no height feature) and
   GroupFree3D (B=8, N=50000, 6 decoder layers), both with 8192
   candidates: a step's FLOPs and bytes, MFU_ITERS steps timed, each
   share of the card's peaks in (0, 100], the launches of every step and
   the shapes checked (VoteNet's SA1 grouping without features and GF's
   FPS over 8192 candidates of 50000-point rows have records of their
   own in phase 2).
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
   the switch's cost, bitwise repeatability gated). The learning check
   (after item 8's exact-mode phases, beside the parity pairs):
   ``gf_fsb`` on the shapefix train split at the JAX package's
   shapefix configuration (N=20000, height, subset FPS over 8192) for 50
   epochs of 5 steps, each epoch's loss beside the JAX run's
   (``evidence/round5/gflad/f32_metrics.jsonl``); fails unless the mean
   loss over epochs 40-49 lies within 0.67-1.5 times the JAX run's and
   mAP@0.25 at epoch 49 reaches 0.30.
8. ``--query_mode exact``, the reference's first-k query (``ops.ball_query``,
   the kernels of ``bq_exact_launch`` in ``csrc/ball_query.cu`` on the
   card: lanes on centres, the row staged in shared memory, or lanes on
   points; the tile by ``ops/ball_query.py::exact_plan``).
   The reference's initial
   checkpoints in the repo (``evidence/round5/{wsb,br,gf}/
   ref_init_checkpoint.tar.gz``) converted by the port's
   ``tools.torch_import`` CLI, each restored into its graph with no entry
   left fresh. ``evaluate --query_mode exact`` serving WSB's init
   (VoteNet, B=8, N=40000) and GF's (2 decoder layers, feed-forward 128,
   height, N=50000): FPS and the exact query 5 and 4 launches a forward,
   K3 and K4 none; a batch timed. ``[exact query]``: the kernel at every
   input those servings gave it (the five VoteNet layers, GF's SA1) and
   on the edge clouds of ``exact_edge_clouds`` (exactly S hits and S + 1,
   hits across a 32- and a 128-point boundary, N = 1000 and 2049,
   S = 96, a centre whose only hit is the last point, a block's centres
   leaving far apart, S-th hits at both ends of a staged chunk and of a
   round, a row shorter than a chunk, 33 centres a row): every tile of
   ``exact_tiles`` bitwise equal to the others; the plan's against the
   plain version on the card and on the CPU, equal except at centres whose
   first differing slot holds a point within K3's rounding rule of the
   radius (counted; none on the edge clouds, whose planted rows are
   checked), the plain version on the card against the CPU within 1e-5
   r^2; slot 0 bitwise K3's global first hit; each tile's tests executed
   (its counter) at least those the data needs, within 127 a centre of
   them where lanes hold points and exactly the walk of its blocks over
   its own output (``ops.ball_query.exact_walked``) where they hold
   centres; float64 bitwise the plain float64
   version at SA1, SA3 and the edge clouds; bfloat16 and float16 taken as
   float32; the plan's tile and every tile timed beside the plain version,
   K3 and the bound, with its peak memory. Then the round-5 system-parity pairs (WSB, BR,
   CenterRefine, GF), in a process of their own (``--child pairs``)
   beside the learning check and ``[datagen -> br]``, on the ``parity``
   and ``br`` fixtures of the port's
   ``tools.parity_fixture``, each recipe's ``main`` with the JAX leg's
   flags (held to its ``ours_config.json``), WSB, BR and GF from the
   imported inits, CenterRefine from scratch, for 51, 30, 30 and 51
   epochs; ``tools.parity_report`` against the reference loop's history;
   fails unless the late ratio (the mean train loss over the last 11
   matched epochs over the reference's) lies within 0.85-1.15, printed
   beside the JAX leg's, with the mAP rows (not gated); the exact query
   5, 5, 6 and 4 launches a forward (CenterRefine's jitter head queries
   too), and its kernel held and timed as above at every input of the
   pairs' that the servings did not give it, once the pairs and
   ``[preemption]`` have ended.
   ``[datagen -> br]``, the paper's data path on the port's own datagen:
   16 ScanNet-format scans (60000 floor and wall vertices and 5 or 6
   labelled md40 objects each, 4 of them holding a keyboard, cup or
   bottle) and 2 Matterport-format houses of 4 regions (4-6 turned
   objects each) written after the exact-mode phases, their real domains
   exported (``export-real``; ``organize-matterport``,
   ``export-real-matterport``) and the two syntheses (``synthesize
   --procedural --num_aug 2``, ``synthesize-matterport --procedural``)
   started as processes of the port's datagen CLI, run beside the
   learning check and the parity pairs; then
   their walls and the collision test's share printed, at least 16 and 8
   virtual scenes required, and ``votenet_br.main`` at B=8, N=40000,
   ``--fps_candidates 8192`` on each (ScanNet one epoch of 2 steps,
   Matterport two of one, with rotated boxes and 12 heading bins), an
   evaluation each and the launches checked; one serving forward of the
   ScanNet BR model through ``eval.dump_helper.dump_results``, its PLYs
   required.
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
   order of the sums differs, and it flips ReLU masks and max-pool
   winners within rounding of a tie; their counts printed); with world
   1's discrete choices replayed (``Pinned``; the ball query runs live),
   every tensor within 1e-4 of its largest magnitude or 4 times its own
   error in the reversal; both ranks bitwise equal, two runs bitwise
   equal, each rank's launches a forward and a step checked; each step's
   wall and peak memory a rank.
   Then the JAX package's two-process contract (tests/test_multiprocess.py)
   for ``votenet_fsb`` (2 epochs, then ``--resume`` for a third),
   ``votenet_br`` and ``gf_fsb`` (1 epoch; these two beside the first),
   two ``--multihost`` processes on the card, batch 4 each, on the 16-scan
   fixtures: equal epoch losses
   on both ranks, rank 0's checkpoints only, ``log_train.txt.rank1``, an
   evaluation in both logs. ``[preemption]`` (in a process of its own,
   ``--child preemption``, started beside the learning check):
   ``votenet_fsb`` with ``--guard_every_steps 1`` in a process of its
   own, sent SIGTERM in its second epoch: exit 143, the checkpoint (epoch
   0) bitwise the state after as many steps replayed, ``--resume``
   finishes; after data parallelism one ``guard.update`` timed for
   VoteNet's and GF's state. ``[gf sweep]`` (``--child gf_sweep``, beside
   the learning check too): ``tools/gf_sweep.py --seeds 0 --candidates
   8192 --max_epoch 2 --num_point 20000`` on the 16 GF scans, two lines,
   the exact arm first, finite scores, its launches. ``[profile]``:
   ``votenet_fsb.main --profile_dir`` over 16 steps writes a trace of steps
   10-15 naming the FPS, ball-query and grouping kernels.
10. Print each phase's seconds, the card's name and power limit, one JSON
   line with every kernel's numbers (times summed over the VoteNet FSB
   training path's shapes, the exact query's over the VoteNet exact
   serving's; launches by path, the GF, exact, data-parallel and
   model-surface paths included; the exact query's on every exact path
   and on no other); then fail if a
   bfloat16 checkpoint gate of phase 6 failed (its verdict waits for the
   later phases), else print as the last line ``{"ok": true, "device":
   {"platform": "gpu", ...}}``.

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
# votenet_br on the port's own virtual scenes: ScanNet, Matterport
DATAGEN_PATHS = ("datagen_br", "datagen_br_matterport")
TRAINING = ("training", "wsb", "br", "br_center_refine") + DATAGEN_PATHS
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
# [model surface]: the VoteNet model surface no recipe runs (BoxNet, the
# separate-DA criterion, VoteNetDAJitter2, the SA-only backbone, the SA/FP
# variants); each path's records are the ones of the shapes it launched at
# (`ShapeLog`, `tag_paths`)
SURFACE_TRAINING = ("boxnet", "da_separate", "da_jitter2",
                    "surface_variants")
SURFACE_SERVING = ("cam",)
# this slice's paths logged by `ShapeLog`: --cluster_sampling random in
# votenet_fsb and votenet_br, tools/mfu.py's two steps (VoteNet without the
# height feature, GF with 8192 candidates), tools/jitter_diag.py's
# forwards of the CenterRefine checkpoint; tools/gf_sweep.py (N=20000, in a
# process of its own) has its launches counted
TOOL_TRAINING = ("random_fsb", "random_br", "mfu_votenet", "mfu_gf")
TOOL_SERVING = ("jitter_diag",)
MFU_ITERS = 30
SWEEP_TIMEOUT = 600  # seconds for tools/gf_sweep.py in its process
PREEMPTION_TIMEOUT = 600  # seconds for [preemption]'s process
# launches per forward (FPS, ball query, the fused grouping) and grouping
# backwards per train step, by model graph. A DA step runs two forwards
# and one backward: SA2-SA4 and vote clustering in each, and in
# CenterRefine the jitter head's layer in each forward and its backward in
# the source's only (the target's jitter prediction refines labels that
# are detached). GroupFree3D samples its queries by KPS (a top-k, no
# kernel): SA1-SA4 a forward, SA2-SA4 a backward; its CenterRefine graph
# adds the jitter head's layer, in evaluation too (it takes the GT centres).
# BoxNet: VoteNet's five layers, its vote clustering over the seeds, whose
# FP2 features take a gradient (4 backwards). VoteNetDAJitter2's head
# groups the aggregated votes with their features detached but their
# positions not: one more layer a forward, and its backward (the
# positions' gradient) in the source's only, as CenterRefine's head.
# --cluster_sampling random draws the proposals' seeds: no vote FPS (SA1-SA4
# only), the vote clustering's ball query and grouping as under vote_fps
PER_FORWARD = {"plain": (5, 5, 5), "da": (5, 5, 5), "da_jitter": (5, 6, 6),
               "gf": (4, 4, 4), "gf_da": (4, 4, 4),
               "gf_da_jitter": (4, 5, 5), "boxnet": (5, 5, 5),
               "da_jitter2": (5, 6, 6), "cam": (4, 4, 4),
               "random": (4, 5, 5), "da_random": (4, 5, 5)}
# BatchNorms a forward of each graph, every one a BatchNorm -> ReLU pair:
# an eval forward with grad off launches the bn_relu kernel once for each,
# a train-mode forward (training, BN recalibration) never. GroupFree3D's
# graphs add 4 a decoder layer (`bn_per_forward`): two position embeddings
# and a box head of two
BN_PER_FORWARD = {"plain": 23, "da": 27, "da_jitter": 31, "gf": 20,
                  "gf_da": 24, "gf_da_jitter": 26, "boxnet": 21,
                  "da_jitter2": 29, "cam": 12, "random": 23,
                  "da_random": 27}
BACKWARDS_PER_STEP = {"plain": 4, "da": 8, "da_jitter": 9, "gf": 3,
                      "gf_da": 6, "gf_da_jitter": 7, "boxnet": 4,
                      "da_jitter2": 9, "cam": 0, "random": 4,
                      "da_random": 8}
# the checkpoint gate: the JAX package's scores of lad_f32 on the 100-scan
# shapefix val (subset FPS over 8192 candidates, 3 subsample seeds;
# evidence/round5/r5_ladeval_f32.out), mean and its own spread per IoU
GATE_CHECKPOINT = "evidence/round4/ckpt/lad_f32.tar.gz"
GATE = {0.25: (0.8210, 0.0064, (0.8234, 0.8138, 0.8258)),
        0.5: (0.6202, 0.0226, (0.6439, 0.5990, 0.6178))}
# the bfloat16 checkpoint gates: the JAX package's checkpoints trained with
# --bf16 --f32_tail N (evidence/round4/lad_t{1,2,4}_config.json) scored by
# its evaluate with that flag after 20 batches of BN recalibration on the
# shapefix train split (evidence/round5/queue/s2_ladder_bigval.sh; the
# scores in evidence/round5/r5_ladeval_t{1,2,4}.out, lines 8 and 55, and
# RESULTS.md:1036-1041): checkpoint, N, and per IoU mean, spread and
# seeds. The card's mean must lie within GATE_BF16_BAND spreads: the JAX
# spread is the subsample seeds' only, and bfloat16 products accumulate in
# another order on the TPU's matrix units than on Hopper's tensor cores
GATES_BF16 = {
    "lad_t2": ("evidence/round4/ckpt/lad_t2.tar.gz", 2,
               {0.25: (0.7571, 0.0056, (0.7636, 0.7543, 0.7535)),
                0.5: (0.4982, 0.0186, (0.4981, 0.5169, 0.4797))}),
    "lad_t1": ("evidence/round4/ckpt/lad_t1.tar.gz", 1,
               {0.25: (0.7265, 0.0044, (0.7311, 0.7259, 0.7224)),
                0.5: (0.4541, 0.0133, (0.4601, 0.4633, 0.4389))}),
    "lad_t4": ("evidence/round4/ckpt/lad_t4.tar.gz", 4,
               {0.25: (0.7633, 0.0140, (0.7684, 0.7742, 0.7475)),
                0.5: (0.5134, 0.0078, (0.5190, 0.5167, 0.5045))}),
}
GATE_BF16_BAND = 2
# a gate's second term: how far the JAX package's own score moves from its
# TPU to IEEE float32 on a CPU (the same flags, 3 seeds, the 100-scan val,
# the JAX package's evaluate on a CPU host; ROADMAP §C.10): the JAX CPU
# mean by IoU, its distance from the TPU mean added to the band. Only
# where it was measured: the other gates have no such term
GATE_PLATFORM = {
    "lad_t4": {0.25: 0.7681, 0.5: 0.5210},
}
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
    rec = dict(shape=label, dims=fps_dims(xyz, npoint, candidates), ms=ms,
               plain_ms=plain, bound_ms=bnd, bound_by=by, max_abs_err=0,
               us_per_sample=per_sample, layout=tuple(layout))
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
    dims = bq_dims(xyz, ctr, radius, nsample)
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
        return dict(shape=label, dims=dims, max_abs_err=max_gap)
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
    return dict(shape=label, dims=dims, ms=mine["ms"], plain_ms=plain,
                bound_ms=bnd, bound_by=by, max_abs_err=max_gap,
                boundary_points=boundary,
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


def boundary_free_radius(xyz, centres, r, margin=1e-5):
    """Smallest radius >= r with no centre-point squared distance (float64,
    of the float32 values) within `margin` of r^2: an expanded-form f32
    test rounds by about 1e-6 there, differently in each implementation,
    so a point that close to the radius could fall either way."""
    import numpy as np

    d2 = np.sort(np.sum((centres[:, :, None, :].astype(np.float64)
                         - xyz[:, None, :, :].astype(np.float64)) ** 2,
                        axis=-1).ravel())
    r2 = r * r
    while True:
        i = np.searchsorted(d2, r2 - margin)
        if i == d2.size or d2[i] >= r2 + margin:
            return float(np.sqrt(r2))
        r2 = d2[i] + 2 * margin


def exact_edge_clouds(seed=0):
    """The exact first-k query's edge cases, what its scan and its tail
    can get wrong, as dicts of label, xyz (2, N, 3) and centres (2, M, 3)
    float32 numpy arrays (M = 32 unless a case says otherwise), radius and
    nsample, and `planted`: the hit indices of the first centres of each
    row, which sit alone at (20 + 5k, 20, 20) with their hits within 0.05
    of them (the other centres and points lie in [0, 2)^3, the radius is
    boundary-free). The CPU tests hold the port against the JAX package on
    these clouds, the smoke every tile of the kernel against the plain
    version."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def case(label, n, nsample, r, planted, m=32):
        xyz = rng.random((2, n, 3)) * 2.0
        centres = xyz[:, rng.permutation(n)[:m]] + rng.normal(
            size=(2, m, 3)) * 0.05
        for k, hits in enumerate(planted):
            at = np.array([20.0 + 5 * k, 20.0, 20.0])
            centres[:, k] = at
            if hits:
                xyz[:, hits] = at + rng.uniform(-0.05, 0.05,
                                                (2, len(hits), 3))
        xyz, centres = xyz.astype(np.float32), centres.astype(np.float32)
        return dict(label=label, xyz=xyz, centres=centres,
                    radius=boundary_free_radius(xyz, centres, r),
                    nsample=nsample, planted=planted)

    def scattered(n, *sizes):
        """Disjoint sorted index lists of `sizes`."""
        pool, out = rng.permutation(n).tolist(), []
        for k in sizes:
            out.append(sorted(pool[:k]))
            pool = pool[k:]
        return out

    def ending_at(keys, nsample):
        """A hit list for each of `keys` whose nsample-th hit is that key,
        the earlier hits drawn below it, all lists disjoint."""
        used, out = set(keys), []
        for key in keys:
            free = [j for j in range(key) if j not in used]
            early = sorted(rng.choice(free, nsample - 1,
                                      replace=False).tolist())
            used.update(early)
            out.append([*early, key])
        return out

    def round_edges():
        """Lanes on centres stage chunks of 64 points, rounds of 256 or 512
        (4 or 8 chunk groups): nsample-th hits at both ends of each, every
        centre planted, so that a block leaves as early as its slowest
        centre lets it (with 32 centres a block, the first block after
        point 511, the second after 1024)."""
        first = [63, 64, 127, 128, 255, 256, 447, 448, 511]
        first += rng.choice(np.setdiff1d(np.arange(200, 511), first),
                            32 - len(first), replace=False).tolist()
        second = [512, 575, 576, 767, 768, 1023, 1024]
        second += rng.choice(np.setdiff1d(np.arange(600, 1024), second),
                             32 - len(second), replace=False).tolist()
        return case("round_edges", 2049, 8, 0.3,
                    ending_at(first + second, 8), m=64)

    return [
        # no hit; exactly nsample hits; nsample + 1
        case("s_hits", 1000, 16, 0.3, [[], *scattered(1000, 16)]),
        case("s_plus_1", 1000, 16, 0.3, scattered(1000, 17, 15)),
        # hits across a 32-point and a 128-point boundary: the 16th at
        # 137, 16 ending at 155, 2 (the tail from 95)
        case("straddle", 1000, 16, 0.3, [
            [30, 31, 32, 33, *range(126, 139)], list(range(140, 156)),
            [95, 96]]),
        # N no multiple of 32: the last point alone, and the 7 before it
        case("n1000", 1000, 32, 0.4, [[999], list(range(992, 999))]),
        case("n2049", 2049, 16, 0.3, [[2048], [0, 2047]]),
        # more slots than the stratified query takes (64)
        case("s96", 3000, 96, 0.45, scattered(3000, 97, 95)),
        # a centre whose only hit is point N - 1
        case("last_only", 2049, 64, 0.3, [[2048], []]),
        # one block's centres leaving far apart: all nsample hits in the
        # first chunk, none, the nsample-th at the row's last point
        case("leave_apart", 2049, 16, 0.3, [
            sorted(rng.choice(64, 16, replace=False).tolist()), [],
            sorted((64 + rng.choice(1984, 15, replace=False)).tolist())
            + [2048]]),
        round_edges(),
        # a row shorter than one chunk, the last hit its last point
        case("n50", 50, 8, 0.3, [[3, 10, 20, 30, 40, 45, 48, 49], []]),
        # 33 centres, all planted: a block of one centre past any tile's
        # centres; 15, 16 or 17 hits each
        case("m33", 1000, 16, 0.3,
             scattered(1000, *[15 + k % 3 for k in range(33)]), m=33),
    ]


def exact_expected(planted, nsample):
    """The planted centres' slots: each one's first nsample hits, then its
    first hit (index 0 in every slot where it has none)."""
    out = []
    for hits in planted:
        row = hits[:nsample]
        out.append(row + [row[0] if row else 0] * (nsample - len(row)))
    return out


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


def check_bq_tiles(label, xyz, ctr, radius, nsample, bq):
    """[ball query tiles]: every tile :func:`tiles` lists for the shape
    gives bitwise the same idx and hit, and so does every tile on the first
    B / 2 rows alone (a rank's share) against those rows among B: a row's
    slots do not depend on the tile nor on the rows of a launch."""
    import torch

    b, n, _ = xyz.shape
    m = ctr.shape[1]
    ref, counted = None, []
    for rows in (b, b // 2):
        tiles = bq.tiles(rows, n, m, nsample)
        require(bq.plan(rows, n, m, nsample) in tiles,
                f"bq tiles {label}: the plan's tile is not listed")
        for tile in tiles:
            idx, hit = bq._ball_query_stratified_cuda(
                xyz[:rows], ctr[:rows], radius, nsample, tile)
            if ref is None:
                ref = idx, hit
            off = ((idx != ref[0][:rows]) | (hit != ref[1][:rows])).sum()
            require(off.item() == 0,
                    f"bq tiles {label} [{tile_name(bq, tile)}] at"
                    f" B={rows}: {off.item()} slots differ from"
                    f" [{tile_name(bq, tiles[0])}] at B={b}")
        chosen = tile_name(bq, bq.plan(rows, n, m, nsample))
        counted.append(f"{len(tiles)} at B={rows} (plan [{chosen}])")
    torch.cuda.synchronize()
    print(f"[ball query tiles] {label} N={n} M={m} S={nsample}: every tile"
          f" bitwise equal, {' and '.join(counted)}")


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
    dims = group_dims(idx, n, c)
    fwd = dict(shape=label, dims=dims, ms=fwd_ms, plain_ms=fwd_plain,
               library_ms=fwd_lib, bound_ms=fwd_bound, bound_by=fwd_by,
               max_abs_err=0)
    bwd = dict(shape=label, dims=dims, ms=bwd_ms, plain_ms=bwd_plain,
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
    dims = group_dims(idx, n, c)
    fwd = dict(shape=label, dims=dims, ms=fwd_ms, plain_ms=fwd_plain,
               library_ms=None, bound_ms=fwd_bound, bound_by=fwd_by,
               max_abs_err=0)
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
        bwd = dict(shape=label, dims=dims, ms=bwd_ms, plain_ms=bwd_plain,
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


def fps_dims(xyz, npoint, candidates=None):
    """FPS's launch shape, as its records and `ShapeLog` carry it: (B, N,
    npoint, candidates)."""
    return (*xyz.shape[:2], npoint, candidates)


def same_layout(x, device=None):
    """A copy of `x` with its strides, on `device` (default its own): a
    view keeps the layout a kernel's wrapper is given (SA1's xyz is the
    first 3 of each point's 4 values), which `clone` and `to` make
    contiguous."""
    import torch

    out = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                              device=x.device if device is None else device)
    return out.copy_(x.detach())


def bq_dims(xyz, new_xyz, radius, nsample):
    """The ball query's: (B, N, M, S, radius)."""
    return (*xyz.shape[:2], new_xyz.shape[1], nsample, float(radius))


def group_dims(idx, n, width):
    """The grouping's, unfused or fused: (B, N, M, S, C), C the points'
    width (unfused) or the features' (fused)."""
    return (idx.shape[0], n, *idx.shape[1:], width)


class ShapeLog:
    """The shapes the kernels launch at in a block (``with ShapeLog() as
    log``), as the nn modules reach them (``backtoreality_tpu_torch.ops.
    <name>``): `shapes` holds (kind, dims) of each FPS, ball query (exact:
    "ball_query_exact") and fused grouping call, the grouping also as the
    unfused kernel it counts as (C = 3 + the features' width), and each as
    a backward ("localize_backward", "group_backward") where an input
    takes a gradient. `inputs` keeps a copy of the first (xyz, centres,
    radius, nsample) of the exact query at each of its dims, in the
    layout it was given (`same_layout`)."""

    def __enter__(self):
        import torch

        from backtoreality_tpu_torch import ops

        self.shapes = set()
        self.inputs = {}
        fps, query, local, exact = (ops.furthest_point_sample,
                                    ops.ball_query_stratified,
                                    ops.group_localize_stratified,
                                    ops.ball_query)

        def fps_logged(xyz, npoint, candidates=None):
            self.shapes.add(("fps", fps_dims(xyz, npoint, candidates)))
            return fps(xyz, npoint, candidates)

        def query_logged(xyz, new_xyz, radius, nsample, return_hit=False):
            self.shapes.add(("ball_query",
                             bq_dims(xyz, new_xyz, radius, nsample)))
            return query(xyz, new_xyz, radius, nsample, return_hit)

        def exact_logged(xyz, new_xyz, radius, nsample, *args, **kwargs):
            dims = bq_dims(xyz, new_xyz, radius, nsample)
            self.shapes.add(("ball_query_exact", dims))
            if dims not in self.inputs:
                self.inputs[dims] = (same_layout(xyz),
                                     same_layout(new_xyz), radius, nsample)
            return exact(xyz, new_xyz, radius, nsample, *args, **kwargs)

        def local_logged(xyz, features, new_xyz, idx, hit, radius):
            c = 0 if features is None else features.shape[-1]
            n = xyz.shape[1]
            kinds = [("localize", group_dims(idx, n, c)),
                     ("group", group_dims(idx, n, 3 + c))]
            if torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad
                    for t in (xyz, features, new_xyz)):
                kinds += [(k + "_backward", d) for k, d in kinds]
            self.shapes.update(kinds)
            return local(xyz, features, new_xyz, idx, hit, radius)

        self.saved = patch_ops(furthest_point_sample=fps_logged,
                               ball_query_stratified=query_logged,
                               group_localize_stratified=local_logged,
                               ball_query=exact_logged)
        return self

    def __exit__(self, *exc):
        restore_ops(self.saved)


def tag_paths(shapes_by_path, records):
    """Each path onto the records (`records` by kind, as `ShapeLog` names
    them) of the shapes it launched at. Fails where a path launched FPS,
    the ball query or the fused grouping, forward or backward, at a shape
    that no record holds against its plain version; the unfused
    grouping's records (the same kernel at the points' width) take the
    paths whose shapes they hold."""
    strict = ("fps", "ball_query", "localize", "localize_backward",
              "ball_query_exact")
    for path, shapes in shapes_by_path.items():
        for kind, dims in sorted(shapes, key=str):
            held = [r for r in records[kind]
                    if tuple(r.get("dims", ())) == dims]
            require(held or kind not in strict, f"{path}: {kind} launched"
                    f" at {dims}, a shape with no check against the plain"
                    " version")
            for r in held:
                r["paths"] = tuple(r.get("paths", ())) + (path,)


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


def bn_relu_shapes(model, inputs) -> list:
    """The (rows, C) of each launch of the eval-mode BatchNorm and ReLU
    kernel in one forward of `model` on `inputs` with grad off, in order.
    Every BatchNorm of the model must launch it once."""
    import torch

    from backtoreality_tpu_torch.nn import BatchNorm
    from backtoreality_tpu_torch.ops import bn_relu

    shapes, launch = [], bn_relu.bn_relu

    def logged(x, mean, inv, bias):
        shapes.append((x.numel() // x.shape[-1], x.shape[-1]))
        return launch(x, mean, inv, bias)

    launches = bn_relu.KERNEL.launches
    bn_relu.bn_relu = logged
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        bn_relu.bn_relu = launch
    layers = sum(isinstance(m, BatchNorm) for m in model.modules())
    launched = bn_relu.KERNEL.launches - launches
    require(len(shapes) == layers == launched, f"bn_relu: {launched}"
            f" launches ({len(shapes)} calls) in a forward of a model of"
            f" {layers} BatchNorms")
    return shapes


def check_bn_relu(label, rows, c, reps, device, dtype=None):
    """The kernel on a (rows, C) x of `dtype` (float32 by default, or
    bfloat16) against the torch sequence of an eval-mode BatchNorm with
    the statistics, scale and shift drawn here, then torch.relu, as
    BatchNorm runs it off the card: bitwise equal, on inputs holding NaN,
    +-inf, -0 and elements equal to the mean (a zero before the scale, -0
    where the scale is negative and the shift -0). With `reps`, the
    kernel's and the sequence's median times (CUDA events, launches
    queued ahead) and the bytes bound."""
    import torch

    from backtoreality_tpu_torch.nn import BatchNorm
    from backtoreality_tpu_torch.ops import bn_relu

    dtype = dtype or torch.float32
    g = torch.Generator(device=device).manual_seed(rows * 1000 + c)
    bn = BatchNorm(c).to(device).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g, device=device))
        bn.running_mean[0] = bn.running_mean[0].to(dtype).float()
        bn.running_var.copy_(torch.rand(c, generator=g, device=device)
                             + 0.05)
        bn.weight.copy_(torch.randn(c, generator=g, device=device))
        bn.bias.copy_(torch.randn(c, generator=g, device=device))
        bn.weight[0] = -1.5
        bn.bias[0] = -0.0
    x = torch.randn(rows, c, generator=g, device=device) * 3
    x[:, 0] = bn.running_mean[0]
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            0.0], device=device)
    k = min(special.numel(), x.numel())
    x.view(-1)[:k] = special[:k]
    x.view(-1)[-k:] = special[:k]
    x = x.to(dtype)
    with torch.inference_mode():
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        mean, bias = bn.running_mean, bn.bias.detach()

        def plain():
            return torch.relu(((x.float() - mean) * inv + bias).to(dtype))

        want = plain()
        launches = bn_relu.KERNEL.launches
        got = bn(x, relu=True)
    require(bn_relu.KERNEL.launches == launches + 1,
            f"bn_relu {label}: the eval forward with grad off did not"
            " launch the kernel")
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    same = got.dtype == dtype and torch.equal(got.view(ints), want.view(ints))
    require(same, f"bn_relu {label} ({rows}, {c}) {dtype}: not bitwise the"
            " torch sequence")
    rec = {"label": label, "rows": rows, "c": c, "dtype": str(dtype),
           "max_abs_err": 0.0}
    if reps:
        with torch.inference_mode():
            ms = cuda_ms(lambda: bn_relu.bn_relu(x, mean, inv, bias),
                         reps=reps, warmup=2, ahead=True)
            plain_ms = cuda_ms(plain, reps=reps, warmup=2, ahead=True)
        bound, by = bound_ms(0, 2 * rows * c * x.element_size() + 4 * 3 * c)
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   roofline=bound / ms)
        print(f"  {label} ({rows}, {c}) {dtype}: {ms:.4f} ms, plain"
              f" {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}),"
              f" {bound / ms:.1%} of it; bitwise equal")
    return rec


def bn_relu_phase(model, pc, gf_scans, cfg, device):
    """``[bn_relu]``: the shapes of both serving forwards (VoteNet: `model`
    on `pc`; GroupFree3D at its CLI defaults on the GF fixture's first 8
    scans four times, B=32) each checked once (timed, each shape's ms
    counted as often as a forward runs it), SA1's widths timed, and the
    edge shapes checked; then VoteNet's shapes and the edges in bfloat16
    (``--bf16``), SA1's timed. Returns (records, summary)."""
    import torch

    from backtoreality_tpu_torch.train import groupfree

    torch.manual_seed(0)
    gf = groupfree.build_model(gf_flags(), cfg).to(device).eval()
    gf_pc = gf_first_batch(gf_scans, cfg, use_height=False)["point_clouds"]
    gf_pc = torch.cat([gf_pc] * 4)
    forwards = {"serving": bn_relu_shapes(model, (pc,)),
                "gf_serving_b32": bn_relu_shapes(gf, (gf_pc,))}
    del gf, gf_pc
    print("[bn_relu] eval BatchNorm + ReLU kernel vs the torch sequence"
          " (median of CUDA events)")
    records, timed = [], {}
    for path, shapes in forwards.items():
        print(f"  {path}: {len(shapes)} launches a forward")
        for rows, c in sorted(set(shapes), reverse=True):
            if (rows, c) not in timed:
                timed[rows, c] = check_bn_relu(f"{path}", rows, c, 10,
                                               device)
                records.append(timed[rows, c])
    edges = (("ragged", 1000003, 64), ("ragged_c288", 1009, 288),
             ("one_row", 1, 4), ("c_4", 7, 4), ("c_12", 333, 12))
    for label, rows, c in edges:
        records.append(check_bn_relu(label, rows, c, 0, device))
    # --bf16: the same shapes with a bfloat16 x, SA1's two widths timed
    sa1 = sorted(set(forwards["serving"]), reverse=True)[:2]
    for rows, c in sorted(set(forwards["serving"]), reverse=True):
        records.append(check_bn_relu("serving_bf16", rows, c,
                                     10 if (rows, c) in sa1 else 0, device,
                                     torch.bfloat16))
    for label, rows, c in edges:
        records.append(check_bn_relu(f"{label}_bf16", rows, c, 0, device,
                                     torch.bfloat16))
    summary = {}
    for path, shapes in forwards.items():
        summary[path] = {
            "launches": len(shapes),
            "ms": sum(timed[s]["ms"] for s in shapes),
            "plain_ms": sum(timed[s]["plain_ms"] for s in shapes),
            "bound_ms": sum(timed[s]["bound_ms"] for s in shapes)}
        summary[path]["roofline"] = (summary[path]["bound_ms"]
                                     / summary[path]["ms"])
        print(f"  {path} forward: {summary[path]['ms']:.4f} ms over"
              f" {len(shapes)} launches, plain"
              f" {summary[path]['plain_ms']:.4f} ms, bound"
              f" {summary[path]['bound_ms']:.4f} ms"
              f" ({summary[path]['roofline']:.1%})")
    return records, summary


def reset(counters):
    for k in counters:
        k.launches = 0
        k.backward_launches = 0


def read_counts(counters) -> dict:
    """The launch counters by name (counters: FPS, ball query, grouping,
    fused grouping, exact ball query, eval BatchNorm + ReLU)."""
    fps_k, bq_k, group_k, localize_k, exact_k, bn_k = counters
    return {"fps": fps_k.launches, "ball_query": bq_k.launches,
            "bn_relu": bn_k.launches,
            "ball_query_exact": exact_k.launches,
            "group_stratified": group_k.launches,
            "group_stratified_backward": group_k.backward_launches,
            "group_localize_stratified": localize_k.launches,
            "group_localize_stratified_backward":
                localize_k.backward_launches}


def bn_per_forward(kind, decoder_layers=6):
    """The bn_relu kernel's launches in an eval forward of graph `kind`
    (GroupFree3D's with `decoder_layers`, 6 at its CLI defaults)."""
    return BN_PER_FORWARD[kind] + 4 * decoder_layers * kind.startswith("gf")


def check_counts(label, launches, kind, forwards, steps, evals=0,
                 decoder_layers=6):
    """Launches on a path against the model graph's counts: `forwards`
    forwards (a DA step runs two), `steps` train steps, `evals` of the
    forwards in eval mode with grad off (GroupFree3D's with
    `decoder_layers`)."""
    want = dict(zip(("fps", "ball_query", "group_localize_stratified"),
                    (n * forwards for n in PER_FORWARD[kind])))
    want["group_stratified"] = want["group_localize_stratified"]
    want["ball_query_exact"] = 0
    want["bn_relu"] = bn_per_forward(kind, decoder_layers) * evals
    backward = BACKWARDS_PER_STEP[kind] * steps
    want["group_stratified_backward"] = backward
    want["group_localize_stratified_backward"] = backward
    for name, n in want.items():
        require(launches[name] == n,
                f"{label}: {name} launched {launches[name]} times, expected"
                f" {n} ({forwards} forwards, {steps} steps, {evals}"
                " evaluation forwards)")


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
    check_counts("training", launches, "plain", forwards, steps,
                 math.ceil(NUM_SCANS / B))
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
        check_counts(recipe, launches[recipe], kind, forwards, steps, evals)
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

    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.train import common, votenet

    # as `_train_loop_da`: the target is jittered, the source only for
    # CenterRefine
    target = first_batch(cfg, scans, "all", 0.1)
    flags = votenet.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--fps_candidates", "8192"])
    epoch = 30
    out = {}
    for recipe, kind in (("br", "da"), ("br_center_refine", "da_jitter")):
        jitter = kind == "da_jitter"
        batches = [first_batch(cfg, virtual, "train_aug",
                               0.1 if jitter else 0.0), target]
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


def _rows(log):
    """A run's metrics.jsonl without its wall-clock fields."""
    return [{k: v for k, v in json.loads(line).items()
             if "sec" not in k and "time" not in k}
            for line in (log / "metrics.jsonl").read_text().splitlines()]


def random_sampling_phase(scans, virtual, tmp, counters):
    """``[cluster sampling random]``: ``votenet_fsb.main --cluster_sampling
    random`` (one epoch of 2 steps and an evaluation over the 16 scans,
    B=8, N=40000, 8192 candidates) twice with --seed 0 and once with 1,
    and ``votenet_br.main`` with it (2 steps of 8 + 8 scenes and an
    evaluation). Every forward's draws are read at the proposal module: a
    step's must be those of ``common.draw_generator`` at (seed, step), a
    DA step's source and target at (seed, step, 0) and (seed, step, 1),
    every evaluation batch's at (0,); the two seed-0 runs bitwise equal
    (losses, evaluations, draws), seed 1's draws other. Launches a
    forward: FPS 4 (SA1-SA4, no vote FPS), ball query and fused grouping
    5; 4 grouping backwards a step (8 a DA step). Returns the launches and
    the shapes (`ShapeLog`) of random_fsb and random_br."""
    import torch

    from backtoreality_tpu_torch.train import (common, votenet, votenet_br,
                                               votenet_fsb)

    tmp = pathlib.Path(tmp)
    steps = NUM_SCANS // B
    evals = math.ceil(NUM_SCANS / B)
    base = ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--device", "cuda", "--num_point", str(N),
            "--batch_size", str(B), "--fps_candidates", "8192",
            "--max_epoch", "1", "--eval_freq", "1", "--cluster_sampling",
            "random"]

    def expected(got, *key):
        """What the generator of `key` draws where `got` was drawn."""
        return torch.randint(0, 1024, got.shape, device=got.device,
                             dtype=torch.int32,
                             generator=common.draw_generator(got.device,
                                                             *key))

    launches, shapes, draws = {}, {}, {}
    build = votenet.build_model
    for name, entry, seed, kind in (
            ("random_fsb", votenet_fsb, 0, "random"),
            ("random_fsb_again", votenet_fsb, 0, "random"),
            ("random_fsb_seed1", votenet_fsb, 1, "random"),
            ("random_br", votenet_br, 0, "da_random")):
        seen = draws[name] = []

        def recorded(*args, **kwargs):
            model = build(*args, **kwargs)
            model.pnet.register_forward_hook(
                lambda mod, a, out: seen.append(
                    (mod.training, out["aggregated_vote_inds"].clone())))
            return model

        log = tmp / f"{name}_log"
        args = base + ["--log_dir", str(log), "--seed", str(seed)]
        if kind == "da_random":
            args += ["--source_data_root", str(virtual)]
        votenet.build_model = recorded
        reset(counters)
        t0 = time.perf_counter()
        try:
            with ShapeLog() as shape_log:
                entry.main(args)
            torch.cuda.synchronize()
        finally:
            votenet.build_model = build
        secs = time.perf_counter() - t0
        launches[name] = read_counts(counters)
        shapes[name] = shape_log.shapes
        da = kind == "da_random"
        forwards = (2 * steps if da else steps) + evals
        check_counts(name, launches[name], kind, forwards, steps, evals)
        train = [inds for training, inds in seen if training]
        evaluation = [inds for training, inds in seen if not training]
        keys = ([(seed, i, d) for i in range(steps) for d in (0, 1)] if da
                else [(seed, i) for i in range(steps)])
        require(len(train) == len(keys) and all(
            torch.equal(got, expected(got, *key))
            for got, key in zip(train, keys)), f"{name}: the steps' draws"
            f" are not the generator's of {keys}")
        require(len(evaluation) == evals and all(
            torch.equal(got, expected(got, 0)) for got in evaluation),
            f"{name}: the evaluation batches' draws are not (0,)'s")
        rows = _rows(log)
        require(all(math.isfinite(v) for r in rows for k, v in r.items()
                    if k in ("loss", "mAP")), f"{name}: {rows}")
        print(f"[cluster sampling random] {entry.__name__.split('.')[-1]}"
              f".main --seed {seed}: {steps} steps + one evaluation in"
              f" {secs:.1f} s; launches {launches[name]}; draws of the"
              f" steps {keys} and of {evals} evaluation batches (0,) as"
              f" the generators give them; loss"
              f" {[r['loss'] for r in rows if 'loss' in r]}, mAP@0.25"
              f" {[r['mAP'] for r in rows if 'mAP' in r]}")
    same = (_rows(tmp / "random_fsb_log") == _rows(tmp / "random_fsb_again_log")
            and all(torch.equal(a[1], b[1]) for a, b in
                    zip(draws["random_fsb"], draws["random_fsb_again"])))
    other = not torch.equal(draws["random_fsb"][0][1],
                            draws["random_fsb_seed1"][0][1])
    print(f"[cluster sampling random] two runs of --seed 0 bitwise equal:"
          f" {same}; --seed 1 draws other seeds: {other}")
    require(same and other, "cluster sampling random: seeded runs differ,"
            " or seeds draw alike")
    return ({k: launches[k] for k in ("random_fsb", "random_br")},
            {k: shapes[k] for k in ("random_fsb", "random_br")})


def jitter_diag_phase(scans, tmp, cfg, counters, header):
    """``[jitter_diag]``: ``tools/jitter_diag.py`` on the checkpoint and
    ``config.json`` that `recipe_phase`'s ``votenet_br_center_refine.main``
    wrote, over its target scans, on the card: `objects` must equal the
    valid boxes of those scans (counted here through the dataset), every
    field finite, and each batch launch as the CenterRefine graph's
    forward (5 FPS, 6 ball queries, 6 fused groupings). Returns the
    launches and the shapes (`ShapeLog`)."""
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.tools import jitter_diag

    log = pathlib.Path(tmp) / "br_center_refine_log"
    flags = json.loads((log / "config.json").read_text())
    reset(counters)
    t0 = time.perf_counter()
    with ShapeLog() as shape_log:
        out = jitter_diag.main([
            "--ckpt", str(log / "train_BR_CenterRefine.tar"), "--config",
            str(log / "config.json"), "--data_root", str(scans)])
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    batches = NUM_SCANS // flags["batch_size"]  # the tool drops a remainder
    check_counts("jitter_diag", launches, "da_jitter", batches, 0,
                 batches)
    ds = DetectionDataset(cfg, scans, split="all",
                          num_points=flags["num_point"], use_height=True,
                          center_jitter=flags["center_jitter"])
    valid = sum(int(ds.get(i)["box_label_mask"].sum())
                for i in range(batches * flags["batch_size"]))
    print(f"[jitter_diag] the CenterRefine checkpoint over {NUM_SCANS}"
          f" target scans in {secs:.1f} s: {out}; {valid} valid boxes;"
          f" launches {launches}  | {header}")
    require(out["objects"] == valid and all(
        math.isfinite(v) for v in out.values()),
        f"jitter_diag: {out}, {valid} valid boxes")
    return launches, shape_log.shapes


def mfu_phase(counters, header):
    """``[mfu]``: ``tools/mfu.py`` on the card for VoteNet (B=8, N=40000,
    no height feature, 8192 candidates, Adam at 1e-3) and GroupFree3D
    (B=8, N=50000, 6 decoder layers, 8192 candidates, AdamW in two groups,
    clip 0.1), each over its counted step, a warm-up and MFU_ITERS timed
    steps; their JSON lines printed, each share of the card's peaks in
    (0, 100], the launches of every step checked. Returns the launches,
    the shapes (`ShapeLog`) and the two lines."""
    from backtoreality_tpu_torch.tools import mfu

    launches, shapes, lines = {}, {}, {}
    for model, kind in (("votenet", "plain"), ("gf", "gf")):
        path = f"mfu_{model}"
        reset(counters)
        t0 = time.perf_counter()
        with ShapeLog() as shape_log:
            lines[model] = out = mfu.measure(model, MFU_ITERS, 8192,
                                             device="cuda")
        secs = time.perf_counter() - t0
        launches[path] = read_counts(counters)
        shapes[path] = shape_log.shapes
        steps = MFU_ITERS + 2  # the counted step and the warm-up
        check_counts(path, launches[path], kind, steps, steps)
        shares = {k: out.get(k) for k in ("pct_of_f32_peak",
                                          "pct_of_bf16_peak",
                                          "pct_of_hbm_peak")}
        print(f"[mfu] {model}: {out['flops_per_step'] / 1e9:.1f} GFLOP and"
              f" {out['bytes_per_step'] / 1e9:.2f} GB a step of"
              f" {out['step_ms']:.3f} ms: {out['achieved_tflops']:.3f}"
              f" TFLOP/s, {out['achieved_gbs']:.1f} GB/s; shares {shares}"
              f" ({secs:.1f} s)  | {header}")
        require(all(v is not None and 0 < v <= 100 for v in shares.values()),
                f"mfu {model}: shares {shares}")
    return launches, shapes, lines


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
    print("[kernels] every wrapper of K1-K4 raises TypeError on bfloat16"
          " and float16 inputs, launching nothing")


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
                 steps + RECAL_BATCHES + math.ceil(NUM_SCANS / B), steps,
                 math.ceil(NUM_SCANS / B))
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
                 steps + RECAL_BATCHES + math.ceil(NUM_SCANS / B), steps,
                 math.ceil(NUM_SCANS / B))
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
    with APMatching() as matching:
        results = evaluate.main([
            "--model", "votenet", "--checkpoint_path",
            str(ROOT / GATE_CHECKPOINT), "--data_root", str(val), "--split",
            "all", "--num_point", "20000", "--num_target", "256",
            "--batch_size", "8", "--eval_seeds", "3", "--fps_candidates",
            "8192", "--device", "cuda"])
    secs = time.perf_counter() - t0
    check_counts("checkpoint gate", read_counts(counters), "plain",
                 3 * math.ceil(100 / 8), 0, 3 * math.ceil(100 / 8))
    print(f"[checkpoint gate] subset FPS 8192: evaluate.main, 3 seeds over"
          f" 100 scans, in {secs:.1f} s; {matching.native} calls of the"
          " native IoU")
    require(matching.native > 0, "checkpoint gate: AP matching did not"
            " go through the native IoU")
    gate_check("checkpoint gate", results, GATE, 1)
    return val, matching.calls


class APMatching:
    """Within (``with APMatching() as m``): `m.calls` records what every
    ``APCalculator.compute_metrics`` matches (its predictions, ground
    truth and IoU threshold), and `m.native` counts the calls of the
    native IoU library (``eval.native.box3d_iou_matrix``, as
    ``eval_det`` reaches it)."""

    def __enter__(self):
        from backtoreality_tpu_torch.eval import ap_helper, native

        self.calls, self.native = [], 0
        self._compute = ap_helper.APCalculator.compute_metrics
        self._iou = native.box3d_iou_matrix
        compute, iou = self._compute, self._iou

        def recorded(calc):
            self.calls.append((dict(calc.pred_map_cls),
                               dict(calc.gt_map_cls), calc.ap_iou_thresh))
            return compute(calc)

        def counted(*args):
            self.native += 1
            return iou(*args)

        ap_helper.APCalculator.compute_metrics = recorded
        native.box3d_iou_matrix = counted
        return self

    def __exit__(self, *exc):
        from backtoreality_tpu_torch.eval import ap_helper, native

        ap_helper.APCalculator.compute_metrics = self._compute
        native.box3d_iou_matrix = self._iou


def native_eval_phase(calls, header):
    """``[native eval]``: the AP matching of the lad_f32 gate (every seed's
    and IoU's predictions and ground truth, as `gate_phase` recorded them)
    timed on the card's host through the native IoU library and through
    the Python per-pair loop (a ``get_iou_func`` that is not
    ``get_iou_obb``); fails unless every class's AP agrees within 1e-9."""
    from backtoreality_tpu_torch.eval.box3d import get_iou_obb
    from backtoreality_tpu_torch.eval.eval_det import eval_det

    def python_iou(a, b):
        return get_iou_obb(a, b)

    secs, aps = {}, {}
    for name, fn in (("native", get_iou_obb), ("python", python_iou)):
        t0 = time.perf_counter()
        aps[name] = [eval_det(pred, gt, ovthresh=t, get_iou_func=fn)[2]
                     for pred, gt, t in calls]
        secs[name] = time.perf_counter() - t0
    worst, classes = 0.0, 0
    for nat, py in zip(aps["native"], aps["python"]):
        require(set(nat) == set(py), "native eval: classes differ")
        for c in nat:
            worst = max(worst, abs(nat[c] - py[c]))
            classes += 1
    dets = sum(len(d) for pred, _, _ in calls for d in pred.values())
    print(f"[native eval] lad_f32's AP matching, {len(calls)} calculators"
          f" (3 seeds x 2 IoUs, {dets} detections): native"
          f" {secs['native']:.3f} s, Python loop {secs['python']:.3f} s"
          f" ({secs['python'] / secs['native']:.1f}x); {classes} class APs,"
          f" largest difference {worst:.3g}  | {header}")
    require(worst <= 1e-9, f"native eval: AP differs by {worst}")
    return secs


def gate_check(label, results, table, band, platform=None):
    """Each IoU's 3-seed mean mAP against the JAX package's mean: within
    `band` times its spread, plus, where `platform` gives the JAX
    package's own mean on a CPU at that IoU, the distance of that mean
    from the TPU's; the seeds and both terms printed."""
    failed = []
    for t, (mean, spread, seeds) in table.items():
        got = results[("", t)]
        card = [r["mAP"] for r in got["seeds"]]
        shift = 0.0 if platform is None else abs(platform[t] - mean)
        allowed = band * spread + shift
        within = abs(got["mAP"] - mean) <= allowed
        jax_seeds = " / ".join(f"{v:.4f}" for v in seeds)
        terms = (f"{band} x the spread ({band * spread:.4f})"
                 if platform is None else
                 f"{band} x the spread {band * spread:.4f} + the JAX"
                 f" package's TPU -> CPU shift {shift:.4f} (its CPU"
                 f" {platform[t]:.4f}) = {allowed:.4f}")
        print(f"  mAP@{t}: card {got['mAP']:.4f} (seeds "
              + " / ".join(f"{v:.4f}" for v in card)
              + f"), JAX package {mean:.4f} +/- {spread} (seeds"
              f" {jax_seeds}): gap {abs(got['mAP'] - mean):.5f},"
              f" {'within' if within else 'OUTSIDE'} {terms}")
        if not within:
            failed.append(f"mAP@{t} {got['mAP']:.5f} not within"
                          f" {allowed:.4f} of {mean}")
    require(not failed, f"{label}: " + "; ".join(failed))


def gate_bf16_phase(val, tmp, counters, lap):
    """Score the JAX package's bfloat16 checkpoints on the card as the JAX
    package did (``s2_ladder_bigval.sh``): ``evaluate.main --bf16
    --f32_tail N`` after 20 batches of BN recalibration on the shapefix
    train split (the port's ``write_shapefix_train``, written once), over
    3 subsample seeds of the 100-scan val of `gate_phase`, for lad_t2 (N
    2), lad_t1 (1) and lad_t4 (4). Fails unless each IoU's mean lies
    within GATE_BF16_BAND spreads of the JAX package's, plus for lad_t4
    the JAX package's own shift from its TPU to a CPU (GATE_PLATFORM);
    `lap` closes a phase a checkpoint."""
    from backtoreality_tpu_torch.datagen.shapefix import write_shapefix_train
    from backtoreality_tpu_torch.train import evaluate

    root = pathlib.Path(tmp) / "shapefix_recal"
    t0 = time.perf_counter()
    train, _ = write_shapefix_train(root)
    print(f"[checkpoint gate lad_t2] shapefix train {len(train)} scans"
          f" written in {time.perf_counter() - t0:.1f} s")
    for name, (checkpoint, tail, table) in GATES_BF16.items():
        label = f"checkpoint gate {name}"
        reset(counters)
        t0 = time.perf_counter()
        with APMatching() as matching:
            results = evaluate.main([
                "--model", "votenet", "--checkpoint_path",
                str(ROOT / checkpoint), "--bf16", "--f32_tail", str(tail),
                "--train_data_root", str(root / "train"), "--recal_split",
                "all", "--data_root", str(val), "--split", "all",
                "--num_point", "20000", "--num_target", "256",
                "--batch_size", "8", "--eval_seeds", "3",
                "--fps_candidates", "8192", "--device", "cuda"])
        secs = time.perf_counter() - t0
        check_counts(label, read_counts(counters), "plain",
                     RECAL_BATCHES + 3 * math.ceil(100 / 8), 0,
                     3 * math.ceil(100 / 8))
        print(f"[{label}] --bf16 --f32_tail {tail}, {RECAL_BATCHES}"
              f" recalibration batches, 3 seeds over 100 scans, in"
              f" {secs:.1f} s; {matching.native} calls of the native IoU")
        require(matching.native > 0, f"{label}: AP matching did not go"
                " through the native IoU")
        gate_check(label, results, table, GATE_BF16_BAND,
                   GATE_PLATFORM.get(name))
        lap(label)


def first_batch(cfg, root, split, center_jitter=0.0, augment=True):
    """The first B scans of `root` at N points (height feature) as tensors
    on the card."""
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.train.common import to_device

    ds = DetectionDataset(cfg, root, split=split, num_points=N,
                          use_height=True, augment=augment,
                          center_jitter=center_jitter)
    return to_device(next(iter(DetectionDataLoader(
        ds, B, shuffle=False, prefetch=0))), "cuda")


def patch_ops(**fns):
    """The op library's entries named in `fns` replaced, as the nn modules
    reach them (``backtoreality_tpu_torch.ops.<name>``); returns what
    they were, for `restore_ops`."""
    from backtoreality_tpu_torch import ops

    saved = {k: getattr(ops, k) for k in fns}
    for k, fn in fns.items():
        setattr(ops, k, fn)
    return saved


def restore_ops(saved):
    from backtoreality_tpu_torch import ops

    for k, fn in saved.items():
        setattr(ops, k, fn)


class PlainOps:
    """The op library's kernel entries, as the nn modules reach them
    (``backtoreality_tpu_torch.ops.<name>``), replaced for one run of a
    module: `record` keeps the ball query's (idx, hit) of each call (the
    kernel runs); `replay` takes the plain grouping with those (idx, hit)
    in call order and refuses FPS, whose indices the caller passes. So a
    module runs once through its kernels and once through the plain
    grouping on the same neighbourhoods; the ball query itself is held
    against its plain version by `check_bq` at each of its shapes."""

    def __init__(self):
        self.calls = []

    def record(self):
        from backtoreality_tpu_torch import ops

        real = ops.ball_query_stratified

        def query(*args, **kw):
            out = real(*args, **kw)
            self.calls.append(out)
            return out

        return patch_ops(ball_query_stratified=query)

    def replay(self):
        from backtoreality_tpu_torch.ops import grouping

        calls = iter(self.calls)

        def fps(*args, **kw):
            raise AssertionError("plain run: FPS indices must be given")

        return patch_ops(
            ball_query_stratified=lambda *args, **kw: next(calls),
            group_localize_stratified=(
                grouping._group_localize_stratified_torch),
            furthest_point_sample=fps)



def compare_module(label, module, inputs, grads_of, counters):
    """One module's train-mode forward and backward through the kernels,
    then through the plain grouping on the same neighbourhoods (`PlainOps`)
    from the same state: the output bitwise equal, and the gradients of
    sum(out * g), g fixed, with respect to the inputs named in `grads_of`
    and every parameter each within GROUP_GRAD_RTOL of its largest plain
    entry. `inputs` are the forward's arguments in order (tensors or
    None); a module that samples returns its FPS indices, which the plain
    run is given. Returns the kernel run's launches; the plain run must
    launch nothing."""
    import copy

    import torch

    state = copy.deepcopy(module.state_dict())
    module.train()

    def run(args):
        leaves = [None if t is None else t.detach().clone().requires_grad_(
            i in grads_of) for i, t in enumerate(args)]
        out = module(*leaves)
        feats = out if torch.is_tensor(out) else out[1]
        gen = torch.Generator(feats.device).manual_seed(7)
        g = torch.randn(feats.shape, device=feats.device, generator=gen)
        wrt = [leaves[i] for i in grads_of] + list(module.parameters())
        grads = torch.autograd.grad((feats * g).sum(), wrt,
                                    allow_unused=True)
        return out, feats.detach(), grads

    plain_ops = PlainOps()
    reset(counters)
    saved = plain_ops.record()
    try:
        out, got, g_kernel = run(inputs)
    finally:
        restore_ops(saved)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    # the plain run: the same state, the kernel run's FPS indices
    module.load_state_dict(state)
    plain_inputs = list(inputs)
    if not torch.is_tensor(out) and out[2] is not None:
        plain_inputs.append(out[2])
    reset(counters)
    saved = plain_ops.replay()
    try:
        _, want, g_plain = run(plain_inputs)
    finally:
        restore_ops(saved)
    torch.cuda.synchronize()
    stray = {k: v for k, v in read_counts(counters).items() if v}
    require(not stray, f"surface {label}: the plain run launched {stray}")
    require(torch.equal(got, want),
            f"surface {label}: output kernel != plain at"
            f" {(got != want).sum().item()} of {got.numel()} values")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_kernel, g_plain)):
        if a is None or b is None:
            require(a is None and b is None,
                    f"surface {label}: gradient {i} missing on one side")
            continue
        err = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, err)
        require(err <= GROUP_GRAD_RTOL,
                f"surface {label}: gradient {i} off by {err:.2e} of its"
                f" largest entry, above {GROUP_GRAD_RTOL}")
    module.load_state_dict(state)
    print(f"  surface {label}: output bit-exact, {len(g_kernel)} gradients"
          f" (inputs {list(grads_of)} and parameters) within"
          f" {worst:.1e} of their largest; {len(plain_ops.calls)} ball"
          f" queries; launches {launches}")
    return launches


def add_counts(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def model_surface_phase(scans, virtual, cfg, counters, header, fps, bq,
                        grouping):
    """[model surface]: the VoteNet model surface that no recipe runs, on
    the card through K1/K3/K4 at full width (B=8, N=40000, height).

    * ``boxnet``: `BoxNet` + `get_loss_boxnet` at the FSB bench
      configuration (8192 FPS candidates, 256 proposals, Adam 1e-3, BN
      momentum 0.5), 2 steps and one eval forward (5/5/5 launches a
      forward, 4 grouping backwards a step: vote clustering groups the
      seeds' FP2 features, which take a gradient); then the step timed as
      the other steps (wall, phases, kernels, busy, peak; repeatability
      gated).
    * ``da_separate``: BR's model on 8 + 8 scenes under
      `get_loss_DA_separate`, one step (10/10/10, 8 backwards).
    * ``da_jitter2``: `VoteNetDAJitter2` under CenterRefine's criterion
      (`get_loss_DA_jitter`, epoch 30), two steps (5/6/6 a forward, 9
      backwards a step: the head groups the aggregated votes, their
      features detached but their positions not, so the source's head
      takes a backward for the positions' gradient, the target's none).
      Its head's kernels at their new shape: K3 (N=256 votes, 64 GT
      centres, 16 slots, r=0.8) in every tile, the fused K4 at C = 3 +
      128, scale 1.0, forward and backward (the positions' gradient).
    * ``cam``: a `Pointnet2BackboneCam` forward (4/4/4), timed.
    * ``surface_variants``: at VoteNet's SA widths on one batch,
      `SAModuleMSG` at SA1 (2048 centres, radii 0.1/0.2/0.4, 16/32/64
      slots, [64, 64, 128] each), `SAModuleVotesRlt` at SA2 (1024 of SA1's
      2048, r=0.4, 32 slots, 3 + 2 x 128 wide), `LFPModuleMSG` onto SA3's
      512 points from SA4's 256 (C=256, radii 0.8/1.2, 16 slots each,
      [256, 256] a scale, post-MLP [256, 256]) and `SAModuleVotes` at SA2
      with avg pooling, rbf pooling and ``use_xyz=False``, each in train
      mode through the kernels and again through the plain grouping
      (`compare_module`); K3 in every tile and the fused K4 forward and
      backward at each new (N, M, S, C) against their plain versions.

    Each path's counted run is also logged by shape (`ShapeLog`). Returns
    (launches by path, shapes by path, K3 records, fused K4 forward
    records, fused K4 backward records, the BoxNet step's numbers)."""
    import torch

    from backtoreality_tpu_torch import nn as tnn
    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.models.votenet import (
        BoxNet, Pointnet2BackboneCam, VoteNetDAJitter2)
    from backtoreality_tpu_torch.train import common, evaluate, votenet

    heads = dict(num_class=cfg.num_class,
                 num_heading_bin=cfg.num_heading_bin,
                 num_size_cluster=cfg.num_size_cluster,
                 mean_size_arr=cfg.mean_size_arr, input_feature_dim=1,
                 num_proposal=256, fps_candidates=8192)
    paths, shapes, bq_recs, fwd_recs, bwd_recs = {}, {}, [], [], []
    batch = first_batch(cfg, scans, "all")
    pc = batch["point_clouds"]

    # boxnet: 2 steps and an eval forward, counted; then the step timed
    torch.manual_seed(0)
    model = BoxNet(**heads).cuda()
    opt = common.make_optimizer(model.parameters(), "adam", lr0=1e-3)
    step = votenet.make_train_step(model, opt, vote_losses.get_loss_boxnet,
                                   cfg)
    reset(counters)
    with ShapeLog() as log:
        losses = [step(batch, 0.5)["loss"].item() for _ in range(2)]
        model.eval()
        with torch.no_grad():
            out = model(pc)
    paths["boxnet"], shapes["boxnet"] = read_counts(counters), log.shapes
    require(all(map(math.isfinite, losses)) and out["center"].shape ==
            (B, 256, 3) and bool(torch.isfinite(out["center"]).all())
            and "vote_xyz" not in out,
            f"boxnet: losses {losses}, or the eval forward's centres")
    print(f"[model surface: boxnet] BoxNet + get_loss_boxnet, 2 steps and"
          f" an eval forward: losses {losses}; launches {paths['boxnet']}")
    check_counts("boxnet", paths["boxnet"], "boxnet", 3, 2, 1)
    for _ in range(2):
        step(batch, 0.5)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(batch, 0.5), reps=10, warmup=0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    loss = step(batch, 0.5)["loss"].item()
    require(math.isfinite(loss), "boxnet step loss not finite")
    print(f"[train step] BoxNet B={B} N={N} fps_candidates=8192, Adam lr"
          f" 1e-3, BN momentum 0.5: {step_ms:.3f} ms per step (median of"
          f" 10 after 2 warm-ups), {B / step_ms * 1e3:.1f} scenes/s, peak"
          f" {peak_gb:.2f} GiB, loss {loss:.4f}  | {header}")
    phases = step_phases(
        model, opt, lambda eps: vote_losses.get_loss_boxnet(eps[0], cfg)[0],
        [batch], 0.5)
    print("  phases (median of 5, CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in phases.items()))
    dev_ms = profile_steps(lambda: step(batch, 0.5), "BoxNet steps")
    print(f"  device busy {dev_ms / step_ms:.3f} of the unprofiled step"
          f" ({dev_ms:.3f} of {step_ms:.3f} ms)")
    check_determinism("BoxNet", model, opt, lambda: step(batch, 0.5))
    boxnet_step = dict(ms=step_ms, device_ms=dev_ms, peak_gb=peak_gb,
                       phases=phases)
    del model, opt, step, out

    # da_separate and da_jitter2 on a virtual source and the real target
    flags = votenet.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--fps_candidates", "8192"])
    target = first_batch(cfg, scans, "all", center_jitter=0.1)
    source = first_batch(cfg, virtual, "train_aug")
    torch.manual_seed(0)
    model = evaluate.build_model(flags, cfg, "da").cuda()
    opt = common.make_optimizer(model.parameters(), "adam", lr0=1e-3)

    def separate():
        ep_s = {**source, **model(source["point_clouds"])}
        ep_t = {**target, **model(target["point_clouds"])}
        return vote_losses.get_loss_DA_separate(ep_s, ep_t, cfg)

    reset(counters)
    with ShapeLog() as log:
        aux = common.update(model, opt, 0.5, separate)
    paths["da_separate"] = read_counts(counters)
    shapes["da_separate"] = log.shapes
    print(f"[model surface: da_separate] VoteNetDA + get_loss_DA_separate"
          f" on {B} + {B} scenes, one step: loss {aux['loss'].item():.4f}"
          f" (da {aux['da_loss'].item():.4f}); launches"
          f" {paths['da_separate']}")
    require(math.isfinite(aux["loss"].item()), "da_separate: loss")
    check_counts("da_separate", paths["da_separate"], "da", 2, 1)
    del model, opt

    source = first_batch(cfg, virtual, "train_aug", center_jitter=0.1)
    torch.manual_seed(0)
    model = VoteNetDAJitter2(**heads).cuda()
    opt = common.make_optimizer(model.parameters(), "adam", lr0=1e-3)
    step = votenet.make_da_train_step(model, opt, cfg, jitter=True)
    reset(counters)
    with ShapeLog() as log:
        losses = [step(source, target, 0.5, 30)["loss"].item()
                  for _ in range(2)]
    paths["da_jitter2"] = read_counts(counters)
    shapes["da_jitter2"] = log.shapes
    print(f"[model surface: da_jitter2] VoteNetDAJitter2 +"
          f" get_loss_DA_jitter (epoch 30) on {B} + {B} scenes, 2 steps:"
          f" losses {losses}; launches {paths['da_jitter2']}")
    require(all(map(math.isfinite, losses)), f"da_jitter2: {losses}")
    check_counts("da_jitter2", paths["da_jitter2"], "da_jitter2", 4, 2)
    model.eval()
    with torch.inference_mode():
        ep = model(source["point_clouds"], source["center_label"],
                   source["sem_cls_label"])
    require(ep["center_features"].shape == (B, 64, 128 + cfg.num_class)
            and bool(torch.isfinite(ep["jitter_pred"]).all()),
            "da_jitter2: center_features or jitter_pred")
    head = ("jitter2_head", ep["aggregated_vote_xyz"],
            ep["aggregated_vote_features"], source["center_label"], 0.8, 16)
    print(f"[kernels: VoteNetDAJitter2 head] B={B}, the 256"
          " aggregated votes grouped at the 64 GT centres a scene, C = 3 +"
          " 128, scale 1.0")
    rec = check_bq(*head[:2], *head[3:], bq, reps=5)
    check_bq_tiles(*head[:2], *head[3:], bq)
    fwd, bwd = check_localize(*head, bq, grouping, reps=10, needs=("xyz",),
                              scale=1.0)
    bq_recs.append(rec)
    fwd_recs.append(fwd)
    bwd_recs.append(bwd)
    del model, opt, step, ep, head

    # cam: one forward, timed
    torch.manual_seed(0)
    cam = Pointnet2BackboneCam(input_feature_dim=1).cuda().eval()
    reset(counters)
    with torch.inference_mode(), ShapeLog() as log:
        ep = cam(pc)
        paths["cam"] = read_counts(counters)
        cam_ms = cuda_ms(lambda: cam(pc), reps=10, warmup=1)
    shapes["cam"] = log.shapes
    require(ep["sa4_features"].shape == (B, 256, 256)
            and bool(torch.isfinite(ep["sa4_features"]).all())
            and "fp2_features" not in ep, "cam: sa4 features")
    print(f"[model surface: cam] Pointnet2BackboneCam forward B={B} N={N}:"
          f" {cam_ms:.3f} ms (median of 10); launches {paths['cam']}"
          f"  | {header}")
    check_counts("cam", paths["cam"], "cam", 1, 0, 1)
    del cam, ep

    # surface_variants: the SA/FP variants at VoteNet's SA widths, inputs
    # from a VoteNet forward of the batch
    torch.manual_seed(0)
    net = evaluate.build_model(flags, cfg).cuda().eval()
    with torch.no_grad():
        ep = net(pc)
    del net
    xyz, height = pc[..., :3], pc[..., 3:]
    torch.manual_seed(0)
    modules = [
        ("msg_sa1", tnn.SAModuleMSG(
            2048, (0.1, 0.2, 0.4), (16, 32, 64), 1, [[64, 64, 128]] * 3),
         (xyz, height)),
        ("rlt_sa2", tnn.SAModuleVotesRlt(1024, 0.4, 32, 128,
                                         [128, 128, 256]),
         (ep["sa1_xyz"], ep["sa1_features"])),
        ("lfp_sa4_sa3", tnn.LFPModuleMSG(
            (0.8, 1.2), (16, 16), 256, 256, [[256, 256]] * 2, [256, 256]),
         (ep["sa3_xyz"], ep["sa4_xyz"], ep["sa3_features"],
          ep["sa4_features"])),
    ] + [(f"sa2_{name}", tnn.SAModuleVotes(1024, 0.4, 32, 128,
                                           [128, 128, 256], **kw),
          (ep["sa1_xyz"], ep["sa1_features"]))
         for name, kw in (("avg", dict(pooling="avg")),
                          ("rbf", dict(pooling="rbf")),
                          ("no_xyz", dict(use_xyz=False)))]
    print(f"[model surface: surface_variants] B={B} N={N}, each module in"
          " train mode through the kernels and through the plain grouping"
          " on the same neighbourhoods")
    total = {}
    with ShapeLog() as log:
        for label, module, inputs in modules:
            grads_of = (2, 3) if label.startswith("lfp") else (1,)
            add_counts(total, compare_module(label, module.cuda(), inputs,
                                             grads_of, counters))
    paths["surface_variants"] = total
    shapes["surface_variants"] = log.shapes
    want = dict(fps=5, ball_query=9, ball_query_exact=0, bn_relu=0,
                group_stratified=9, group_localize_stratified=9,
                group_stratified_backward=9,
                group_localize_stratified_backward=9)
    require(total == want, f"surface_variants: launches {total}, expected"
            f" {want} (FPS: MSG, Rlt, 3 SA2 variants; K3 and K4: 3 MSG"
            " branches, Rlt, 2 LFP scales, 3 SA2 variants)")
    del modules
    # the new shapes: K3 in every tile, the fused K4 against its plain
    # version (scale 1.0: no module here normalizes)
    inds = fps.furthest_point_sample(xyz, 2048)
    sa1_ctr = grouping.gather_points(xyz, inds)
    new_shapes = [(f"msg_r{r}", xyz, height, sa1_ctr, r, s)
                  for r, s in ((0.1, 16), (0.2, 32), (0.4, 64))]
    new_shapes.append(("rlt_sa2", ep["sa1_xyz"], ep["sa1_features"],
                       ep["sa2_xyz"], 0.4, 32))
    new_shapes += [(f"lfp_r{r}", ep["sa4_xyz"], ep["sa4_features"],
                    ep["sa3_xyz"], r, 16) for r in (0.8, 1.2)]
    for label, x, f, c, r, ns in new_shapes:
        if label != "rlt_sa2":  # SA2's own query: checked with the paths
            rec = check_bq(label, x, c, r, ns, bq, reps=5)
            check_bq_tiles(label, x, c, r, ns, bq)
            bq_recs.append(rec)
        fwd, bwd = check_localize(label, x, f, c, r, ns, bq, grouping,
                                  reps=10, needs=("features",), scale=1.0)
        fwd_recs.append(fwd)
        bwd_recs.append(bwd)
    return paths, shapes, bq_recs, fwd_recs, bwd_recs, boxnet_step


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
    # tools/mfu.py runs GF with 8192 candidates at SA1
    cand_rec = check_fps("gf_candidates8192", xyz, 2048, fps, reps=3,
                         candidates=8192)
    bq_rec = check_bq("gf_sa1", xyz, ctr, 0.2, 64, bq, reps=5)
    check_bq_tiles("gf_sa1", xyz, ctr, 0.2, 64, bq)
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
    check_bq_tiles(*ctjt[:2], *ctjt[3:], bq)
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
    return ([fps_rec, cand_rec, rank_recs[0]],
            [bq_rec, ctjt_bq, rank_recs[1]],
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
    check_counts("gf_serving", launches, "gf", batches, 0, batches)
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
                     steps + math.ceil(NUM_SCANS / B), steps,
                     math.ceil(NUM_SCANS / B))
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
                     steps, evals)
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
                 steps + math.ceil(len(val) / B), steps,
                 math.ceil(len(val) / B))
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

# the plain exact query on the card against the CPU: a centre may differ
# only where, at its first differing slot, one of the two indices lies
# within this share of r^2 from the radius (the expanded form's f32
# products round differently in the card's and the CPU's matrix products).
# The kernel's test rounds the same form in another order, by up to about
# an ulp of (|c| + |p|)^2 (3e-5 r^2 at r = 0.2 in a room): it is held to
# K3's rule, BQ_GAP_ULPS of (|c| + |p|)^2
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
# each pair's graph, as PER_FORWARD names it (CenterRefine's jitter head
# queries the GT centres: 6 exact queries a forward)
PAIR_GRAPH = {"wsb": "plain", "br": "da", "cr": "da_jitter", "gf": "gf"}
PAIR_LATE = 11  # the late ratio's epochs: the last 11 matched
PAIRS_TIMEOUT = 900  # seconds for the four pairs in their process
PAIR_BAND = (0.85, 1.15)
# flags whose values differ from the JAX leg's by design: paths, the span,
# the start (the JAX legs of BR and GF started fresh; CenterRefine's second
# segment resumed)
PAIR_OWN_FLAGS = {"data_root", "val_data_root", "source_data_root",
                  "log_dir", "checkpoint_path", "max_epoch", "resume",
                  "device"}


def exact_gaps(label, xyz, ctr, radius, got, want, ulps=None):
    """Centres where `got` and `want` (CPU int32) differ: at the first
    differing slot, one of the two indices must lie within EXACT_GAP_REL of
    r^2 from the radius or, with `ulps`, within ulps * 2^-24 (|c| + |p|)^2
    of it (the rounding of the expanded-form test). Returns (centres,
    largest |d2 - r^2| / r^2, largest |d2 - r^2|, largest |d2 - r^2| in
    units of 2^-24 (|c| + |p|)^2), each of the nearer index."""
    import torch

    rows = (got != want).any(-1).nonzero(as_tuple=True)
    if not rows[0].numel():
        return 0, 0.0, 0.0, 0.0
    first = (got[rows] != want[rows]).int().argmax(-1)
    pts = xyz.cpu().double()
    ctrs = ctr.cpu()[rows].double()
    r2 = radius * radius
    gaps, units = [], []
    for idx in (got[rows], want[rows]):
        j = idx.gather(1, first[:, None])[:, 0].long()
        p = pts[rows[0], j]
        gaps.append((((p - ctrs) ** 2).sum(-1) - r2).abs())
        units.append(gaps[-1] / (2.0 ** -24 * (p.norm(dim=-1)
                                               + ctrs.norm(dim=-1)) ** 2))
    near = gaps[0] / r2 <= gaps[1] / r2 if ulps is None else (
        units[0] <= units[1])
    gap = torch.where(near, gaps[0], gaps[1])
    unit = torch.where(near, units[0], units[1])
    worst = (gap.max().item() / r2 if ulps is None else unit.max().item())
    limit = EXACT_GAP_REL if ulps is None else ulps
    require(worst <= limit, f"exact query {label}: a centre differs"
            f" {worst:.2e} {'r^2' if ulps is None else 'ulps'} from the"
            f" radius, beyond {limit}")
    return (int(rows[0].numel()), gap.max().item() / r2, gap.max().item(),
            unit.max().item())


def exact_tests_needed(bq, xyz, ctr, radius, nsample, chunk=256):
    """Distance tests the exact query needs on this data: each centre scans
    up to its nsample-th hit, or every point where it has fewer (the plain
    float32 test, on the card)."""
    import torch

    n = xyz.shape[1]
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    total = 0
    for start in range(0, ctr.shape[1], chunk):
        d2 = bq._pairwise_d2(ctr[:, start:start + chunk].float(),
                             xyz.float())
        cum = (d2 < r2.to(d2.device)).cumsum(-1)
        pos = (cum >= nsample).to(torch.uint8).argmax(-1)
        total += torch.where(cum[..., -1] >= nsample, pos + 1,
                             n).sum().item()
    return total


def exact_query_phase(calls, bq, reps):
    """The exact first-k query's kernel (``ops.ball_query`` on the card, the
    `EXACT` entry) at each call of `calls` (label, xyz, centres, radius,
    nsample, f64, planted) on the card: against the plain version on the
    card (`_ball_query_exact_torch`) and on the CPU, equal except at
    centres whose first differing slot holds a point within the rounding
    of the expanded-form test (BQ_GAP_ULPS of (|c| + |p|)^2, K3's rule)
    from the radius (counted; none where `planted`, a list, gives
    boundary-free edge clouds with known rows), and the plain version on
    the card against the CPU within EXACT_GAP_REL; its slot 0 bitwise K3's
    global first hit (the same radius test); every tile of `exact_tiles`
    bitwise equal to the plan's, each with the tests it executed (its
    counter) at least those the data needs: where lanes hold points at
    most 127 a centre more, where lanes hold centres exactly the walk its
    own output gives (`exact_walked`: a block waits for its slowest
    centre); with `f64`, the float64 instantiation bitwise the plain
    float64 version. With `reps`, the kernel (the plan's tile through
    `ops.ball_query`, and every tile), the plain version and K3 timed
    (CUDA events) beside the bound, and the kernel's peak memory. Returns
    the records."""
    import torch

    records = []
    for label, xyz, ctr, radius, nsample, f64, planted in calls:
        b, n, _ = xyz.shape
        m = ctr.shape[1]
        want = bq.ball_query(xyz.cpu(), ctr.cpu(), radius, nsample)
        plain = bq._ball_query_exact_torch(xyz, ctr, radius, nsample)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = bq.ball_query(xyz, ctr, radius, nsample)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        require(got.dtype == torch.int32 and got.shape == want.shape,
                f"exact query {label}: {got.dtype} {tuple(got.shape)}")
        # the plain version on the card against the CPU: the same
        # expanded form, EXACT_GAP_REL; the kernel against both: its own
        # rounding of that form, as K3's (BQ_GAP_ULPS)
        plain_off, plain_rel, _, _ = exact_gaps(
            f"{label}: the plain version on the card against the CPU", xyz,
            ctr, radius, plain.cpu(), want)
        ulps = BQ_GAP_ULPS * 2**24
        cpu_off, gap_rel, gap, unit = exact_gaps(
            f"{label}: the kernel against the CPU", xyz, ctr, radius,
            got.cpu(), want, ulps)
        card_off, rel2, gap2, unit2 = exact_gaps(
            f"{label}: the kernel against the plain version on the card",
            xyz, ctr, radius, got.cpu(), plain.cpu(), ulps)
        gap_rel, gap, unit = (max(gap_rel, rel2), max(gap, gap2),
                              max(unit, unit2))
        if planted is not None:
            require(cpu_off == card_off == 0, f"exact query {label}: the"
                    " kernel differs from the plain version on a"
                    " boundary-free cloud")
            known = torch.tensor(exact_expected(planted, nsample),
                                 dtype=torch.int32)
            require(bool((got.cpu()[:, :len(planted)] == known).all()),
                    f"exact query {label}: a planted centre's slots")
        # slot 0 against K3's global first hit: the first hit of its first
        # slot that has one (index 0 where none has)
        k_idx, k_hit = bq._ball_query_stratified_cuda(
            xyz.float(), ctr.float(), radius, min(nsample, bq._MAX_SLOTS))
        first = k_hit.to(torch.uint8).argmax(-1, keepdim=True)
        k3_first = torch.where(k_hit.any(-1), k_idx.gather(-1, first)[..., 0],
                               0)
        slot0 = int((got[..., 0] != k3_first).sum().item())
        require(slot0 == 0, f"exact query {label}: slot 0 differs from K3's"
                f" first hit at {slot0} centres")
        tests = exact_tests_needed(bq, xyz, ctr, radius, nsample)
        slack = n * max(cpu_off, card_off)  # centres at the radius
        ct = torch.float64 if xyz.dtype == torch.float64 else torch.float32
        chosen = bq.exact_plan(b, n, m, nsample, ct)
        tiles = bq.exact_tiles(b, n, m, nsample, ct)
        require(chosen in tiles, f"exact query {label}: the plan's tile"
                f" {chosen} is not among the tiles checked")
        per_tile = []
        for tile in tiles:
            name = tile_name(bq, tile)
            counter = torch.zeros(1, dtype=torch.int64, device=xyz.device)
            out = bq._ball_query_exact_cuda(xyz, ctr, radius, nsample, tile,
                                            counter)
            require(torch.equal(out, got), f"exact query {label} [{name}]:"
                    " slots differ from the plan's tile")
            ran = counter.item()
            require(ran >= tests - slack, f"exact query {label} [{name}]:"
                    f" {ran} tests executed, the data needs {tests}")
            if tile.mapping == bq.CENTRES_IN_LANES:
                walked = bq.exact_walked(out, tile, n)
                require(ran == walked, f"exact query {label} [{name}]:"
                        f" {ran} tests executed, its blocks' walk over its"
                        f" own slots is {walked}")
            else:
                require(ran <= tests + 127 * b * m + slack,
                        f"exact query {label} [{name}]: {ran} tests"
                        f" executed, the data needs {tests}")
            per_tile.append(dict(tile=tuple(tile), name=name, executed=ran))
        executed = next(r["executed"] for r in per_tile
                        if r["tile"] == tuple(chosen))
        f64_off = None
        if f64:
            x64, c64 = xyz.double(), ctr.double()
            f64_off = int((bq.ball_query(x64, c64, radius, nsample)
                           != bq._ball_query_exact_torch(
                               x64, c64, radius, nsample)).sum().item())
            require(f64_off == 0, f"exact query {label}: float64 kernel"
                    f" differs from the plain float64 version in {f64_off}"
                    " slots")
        rec = dict(shape=label, dims=bq_dims(xyz, ctr, radius, nsample),
                   xyz_point_stride=xyz.stride(1),
                   plain_boundary_centres=plain_off,
                   plain_max_gap_rel=plain_rel,
                   boundary_centres=max(cpu_off, card_off),
                   max_gap_rel=gap_rel, max_gap_ulps=unit, max_abs_err=gap,
                   tests_needed=tests, executed=executed, peak_mib=peak,
                   f64_slots_differ=f64_off, library_ms=None,
                   tile=tile_name(bq, chosen), tiles=per_tile)
        text = (f"  {label:24s} B={b} N={n} M={m} S={nsample} r={radius}"
                f" (points {xyz.stride(1)} values apart):"
                f" kernel equal to the plain version (card and CPU) but"
                f" {rec['boundary_centres']} centres at the radius (max"
                f" {gap_rel:.2e} r^2, {unit:.2f} ulps of (|c| + |p|)^2;"
                f" plain card / CPU: {plain_off} centres, max"
                f" {plain_rel:.2e} r^2); slot 0 = K3's first hit;"
                f" {len(tiles)} tiles bitwise equal, plan [{rec['tile']}]:"
                f" {executed} tests executed, {tests} needed"
                + ("" if f64_off is None else "; float64 bitwise equal"))
        if reps:
            bnd, by = bound_ms(BQ_OPS_PER_TEST * tests,
                               b * n * 12 + b * m * 12 + b * m * nsample * 4)
            rec.update(bound_ms=bnd, bound_by=by, ms=cuda_ms(
                lambda: bq.ball_query(xyz, ctr, radius, nsample), reps,
                ahead=True), plain_ms=cuda_ms(
                lambda: bq._ball_query_exact_torch(xyz, ctr, radius,
                                                   nsample), 3, ahead=True))
            rec["k3_ms"] = None if nsample > bq._MAX_SLOTS else cuda_ms(
                lambda: bq._ball_query_stratified_cuda(xyz, ctr, radius,
                                                       nsample),
                reps, ahead=True)
            for r in per_tile:
                tile = bq.ExactTile(*r["tile"])
                r["ms"] = cuda_ms(lambda: bq._ball_query_exact_cuda(
                    xyz, ctr, radius, nsample, tile), reps, ahead=True)
            k3 = ("K3 --" if rec["k3_ms"] is None
                  else f"K3 {rec['k3_ms']:.4f} ms")
            text += (f"\n      kernel {rec['ms']:.4f} ms, plain"
                     f" {rec['plain_ms']:.3f} ms"
                     f" ({rec['plain_ms'] / rec['ms']:.1f}x), {k3}, bound"
                     f" {bnd:.4f} ms ({by}), peak {peak:.2f} MiB")
        for r in per_tile:
            text += (f"\n      [{r['name']}]"
                     + (f" {r['ms']:.4f} ms," if "ms" in r else "")
                     + f" {r['executed']} tests executed"
                     f" ({r['executed'] / max(tests, 1):.4f} of needed)"
                     + (" <- plan" if r["tile"] == tuple(chosen) else ""))
        records.append(rec)
        print(text)
    return records


def exact_edge_calls(device):
    """`exact_edge_clouds` on the card, as `exact_query_phase` calls (each
    held in float64 too, and to its planted rows)."""
    import torch

    calls = []
    for c in exact_edge_clouds():
        x, ctr = (torch.from_numpy(c[k]).to(device)
                  for k in ("xyz", "centres"))
        calls.append((c["label"], x, ctr, c["radius"], c["nsample"], True,
                      c["planted"]))
    return calls


def check_exact_half(bq, calls):
    """bfloat16 and float16 inputs to the exact query run the kernel in
    float32 (the plain version's cast): bitwise the float32 call on the
    cast values, and the CPU's result under K3's rule (BQ_GAP_ULPS)."""
    import torch

    label, x, ctr, radius, nsample = calls[0][:5]
    for half in (torch.bfloat16, torch.float16):
        xh, ch = x.to(half), ctr.to(half)
        got = bq.ball_query(xh, ch, radius, nsample)
        require(torch.equal(got, bq.ball_query(xh.float(), ch.float(),
                                               radius, nsample)),
                f"exact query {label}: {half} not taken as float32")
        exact_gaps(f"{label} {half}", xh.float(), ch.float(), radius,
                   got.cpu(), bq.ball_query(xh.cpu(), ch.cpu(), radius,
                                            nsample), BQ_GAP_ULPS * 2**24)
    print(f"[exact query] {label}: bfloat16 and float16 inputs run the"
          " kernel in float32, and agree with the CPU")


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


def check_exact_counts(label, launches, kind, forwards, evals,
                       decoder_layers=6):
    """Launches on an exact-mode path of graph `kind` (PER_FORWARD's):
    FPS and the exact query as many times a forward as the graph's FPS
    and ball query, no stratified ball query and no stratified grouping
    (the gather is plain PyTorch); the eval BatchNorm + ReLU kernel in
    the `evals` of the forwards that are evaluations (GroupFree3D's with
    `decoder_layers`)."""
    want = {k: 0 for k in launches}
    want["fps"] = PER_FORWARD[kind][0] * forwards
    want["ball_query_exact"] = PER_FORWARD[kind][1] * forwards
    want["bn_relu"] = bn_per_forward(kind, decoder_layers) * evals
    for name, n in want.items():
        require(launches[name] == n,
                f"{label}: {name} launched {launches[name]} times, expected"
                f" {n} ({forwards} forwards in exact mode, {evals}"
                " evaluations)")


def exact_serving_phase(scans, gf_scans, inits, cfg, counters, header):
    """``evaluate --query_mode exact`` on the imported reference inits:
    VoteNet (WSB's) at the CLI defaults (B=8, N=40000, FPS over the full
    cloud) on the 16 VoteNet scans, GroupFree3D (GF's, at its widths:
    2 decoder layers, feed-forward 128, height) at N=50000 on the 16 GF
    scans; launch counts (FPS and the exact query 5 and 4 a forward, K3
    and K4 none), finite mAP, then a batch's forward timed (CUDA events),
    peak memory, its kernels' device time (torch.profiler). Returns the
    launches by path, the shapes the kernels launched at by path
    (`ShapeLog`) and the exact query's inputs by its dims."""
    import torch

    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.train import evaluate, groupfree

    batches = math.ceil(NUM_SCANS / B)
    launches, shapes, inputs = {}, {}, {}
    for path, model_flag, ckpt, root, extra, kind in (
            ("serving_exact", "votenet", inits["wsb"], scans,
             ["--num_point", str(N)], "plain"),
            ("gf_serving_exact", "groupfree", inits["gf"], gf_scans,
             GF_INIT_FLAGS, "gf")):
        args = ["--model", model_flag, "--checkpoint_path", str(ckpt),
                "--query_mode", "exact", "--data_root", str(root), "--split",
                "all", "--batch_size", str(B), "--device", "cuda", *extra]
        reset(counters)
        t0 = time.perf_counter()
        with ShapeLog() as shape_log:
            results = evaluate.main(args)
        secs = time.perf_counter() - t0
        launches[path] = read_counts(counters)
        shapes[path] = shape_log.shapes
        inputs.update(shape_log.inputs)
        print(f"[serving path: {model_flag} exact] evaluate.main --query_mode"
              f" exact over {NUM_SCANS} scans in {secs:.1f} s; launches"
              f" {launches[path]} over {batches} batches")
        check_exact_counts(path, launches[path], kind, batches, batches,
                           decoder_layers=2)
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
            print(f"[forward] {model_flag} exact B={B} N={n}: {fwd_ms:.3f}"
                  f" ms per batch (median of 10),"
                  f" {B / fwd_ms * 1e3:.1f} scenes/s, peak {peak_gb:.2f}"
                  f" GiB  | {header}")
            dev_ms = profile_steps(lambda: model(pc), "forwards")
        print(f"  device busy {dev_ms / fwd_ms:.3f} of the unprofiled"
              f" forward")
        del model, out
    return launches, shapes, inputs


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
    the launches by pair, the shapes the kernels launched at by pair
    (`ShapeLog`, as lists) and the file (`torch.save`, on the CPU) of the
    exact query's inputs by its dims, for `exact_query_phase`."""
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
    launches, shapes, inputs = {}, {}, {}
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
        with ShapeLog() as shape_log:
            module.main(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[f"pair_{pair}"] = got = read_counts(counters)
        shapes[f"pair_{pair}"] = sorted(shape_log.shapes, key=str)
        for dims, (x, c, r, k) in shape_log.inputs.items():
            inputs.setdefault(dims, (same_layout(x, "cpu"),
                                     same_layout(c, "cpu"), r, k))
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
        evals *= math.ceil(12 / B)
        fwd = (2 * steps if kind == "br" else steps) + evals
        check_exact_counts(f"pair {pair}", got, PAIR_GRAPH[pair], fwd, evals,
                           decoder_layers=2)
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
    torch.save(inputs, tmp / "exact_inputs.pt")
    return dict(launches=launches, shapes=shapes,
                inputs=str(tmp / "exact_inputs.pt"))


def start_child(tmp, name, payload):
    """Phase `name` of CHILDREN in a process of its own (``chip_smoke.py
    --child NAME DIR``, DIR holding `payload` as input.json), to run
    beside the phases that time no step: the learning check and
    ``[datagen -> br]``. Its numbers do not depend on what runs beside it;
    its wall does."""
    import atexit

    root = pathlib.Path(tmp) / f"{name}_run"
    root.mkdir()
    (root / "input.json").write_text(json.dumps(payload))
    log = open(root / f"{name}.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--child", name,
         str(root)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    # stopped with the smoke, whatever ends it
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return dict(name=name, proc=proc, log=log, root=root,
                start=time.perf_counter())


def finish_child(job, timeout):
    """A child's process to its end (`timeout` seconds from its start),
    its output printed; fails on a nonzero exit. Returns what the phase
    returned (output.json)."""
    left = timeout - (time.perf_counter() - job["start"])
    try:
        rc = job["proc"].wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        job["proc"].kill()
        job["proc"].wait()
        rc = f"killed at its {timeout} s"
    job["log"].seek(0)
    print(job["log"].read().rstrip())
    job["log"].close()
    secs = time.perf_counter() - job["start"]
    print(f"[{job['name']}] its process ended within {secs:.1f} s of its"
          " start")
    require(rc == 0, f"the {job['name']} process exited {rc}")
    return json.loads((job["root"] / "output.json").read_text())


def run_child(name, root, counters, header):
    """In the child process: phase `name` on root/input.json, its result
    written to root/output.json."""
    payload = json.loads((root / "input.json").read_text())
    if name == "pairs":
        inits = {k: pathlib.Path(v) for k, v in payload["inits"].items()}
        out = parity_pairs_phase(root, inits, counters, header)
    elif name == "preemption":
        out = preemption_phase(pathlib.Path(payload["scans"]), root, header)
    elif name == "gf_sweep":
        out = gf_sweep_phase(payload["scans"], root, counters, header)
    else:
        raise SystemExit(f"chip_smoke: no child phase {name!r}")
    (root / "output.json").write_text(json.dumps(out))


def gf_sweep_phase(scans, root, counters, header):
    """``[gf sweep]`` (a child): ``tools/gf_sweep.py --seeds 0 --candidates
    8192 --max_epoch 2 --num_point 20000`` on the 16 GF scans (train and
    val), B=8, 2 decoder layers: two lines, the exact arm first, with
    finite scores; the launches of its 8 steps and 4 evaluation batches
    (4/4/4 a forward, 3 backwards a step). Returns the lines and the
    launches."""
    from backtoreality_tpu_torch.tools import gf_sweep

    reset(counters)
    t0 = time.perf_counter()
    gf_sweep.main(["--data_root", scans, "--val_data_root", scans, "--out",
                   str(root / "out"), "--seeds", "0", "--candidates",
                   "8192", "--max_epoch", "2", "--num_point", "20000"])
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    lines = [json.loads(line) for line in
             (root / "out" / "sweep.jsonl").read_text().splitlines()]
    steps = 2 * 2 * (NUM_SCANS // B)  # two arms of two epochs
    check_counts("gf sweep", launches, "gf",
                 steps + 2 * math.ceil(NUM_SCANS / B), steps,
                 2 * math.ceil(NUM_SCANS / B), decoder_layers=2)
    print(f"[gf sweep] 2 arms x 2 epochs over {NUM_SCANS} scans at"
          f" N=20000 in {secs:.1f} s; launches {launches}  | {header}")
    for rec in lines:
        print(f"  {json.dumps(rec)}")
    require([r["fps_candidates"] for r in lines] == [None, 8192]
            and all(math.isfinite(r[k]) for r in lines
                    for k in ("mAP@0.25", "AR@0.25", "mAP@0.50",
                              "AR@0.50")),
            f"gf sweep: {lines}")
    return dict(lines=lines, launches=launches)


# ---------------------------------------------------------------------------
# [datagen -> br]: the paper's data path through the port's own datagen
# ---------------------------------------------------------------------------

# A room of the scans: its floor (x, y) and wall height in metres, and the
# vertices of its floor, its walls and each object (about 60000 floor and
# wall vertices a scan, as a ScanNet room's mesh holds)
ROOM = (6.0, 5.0, 2.5)
ROOM_FLOOR_POINTS = 50000
ROOM_WALL_POINTS = 10000
OBJECT_POINTS = 4000
# (raw category, footprint x, y and height in metres): md40 furniture, and
# the small classes that gate a scan for the scarce-class pass of
# `synthesize --num_aug`, placed on a piece of furniture
FURNITURE = (("bed", 2.0, 1.5, 0.6), ("table", 1.2, 0.8, 0.75),
             ("chair", 0.5, 0.5, 0.9), ("sofa", 2.0, 0.9, 0.8),
             ("bookshelf", 1.0, 0.35, 1.8), ("desk", 1.2, 0.6, 0.75),
             ("dresser", 1.0, 0.5, 0.9), ("nightstand", 0.5, 0.4, 0.55),
             ("toilet", 0.4, 0.7, 0.8), ("bathtub", 1.6, 0.75, 0.55))
GATED = (("keyboard", 0.45, 0.15, 0.03), ("cup", 0.08, 0.08, 0.1),
         ("bottle", 0.08, 0.08, 0.25))
# Matterport's md40 classes (the adapter's MD40_IDS_MP), in its raw
# category names
MP_FURNITURE = (("bed", 2.0, 1.5, 0.6), ("table", 1.2, 0.8, 0.75),
                ("chair", 0.5, 0.5, 0.9), ("sofa", 2.0, 0.9, 0.8),
                ("desk", 1.2, 0.6, 0.75), ("dresser", 1.0, 0.5, 0.9),
                ("nightstand", 0.5, 0.4, 0.55), ("stool", 0.4, 0.4, 0.45),
                ("bench", 1.4, 0.4, 0.45), ("toilet", 0.4, 0.7, 0.8),
                ("bathtub", 1.6, 0.75, 0.55))
# ScanNet scans: 16 real scans (2 steps of 8 as the target domain), the
# first DATAGEN_GATED of them with a gated object, so that --num_aug 2
# adds two virtual scenes for each; Matterport: 8 regions (2 houses of
# 4), one virtual scene each
DATAGEN_SCANS = 16
DATAGEN_GATED = 4
MP_HOUSES, MP_REGIONS = 2, 4
# the least source scenes: two distinct batches of 8 (ScanNet), one
# (Matterport: 8 regions, two epochs of one step)
DATAGEN_MIN_SCENES = {"scannet": 16, "matterport": 8}
DATAGEN_TIMEOUT = 600  # seconds for a dataset's synthesis
# the port's CLI as `python -m` runs it, with the seconds spent in
# synthesis._min_dist2 (the collision test, the host's hot spot) printed
DATAGEN_TIMED_CLI = (
    "import runpy, time\n"
    "from backtoreality_tpu_torch.datagen import synthesis\n"
    "spent = [0.0, 0]\n"
    "inner = synthesis._min_dist2\n"
    "def timed(a, b):\n"
    "    t = time.perf_counter()\n"
    "    try:\n"
    "        return inner(a, b)\n"
    "    finally:\n"
    "        spent[0] += time.perf_counter() - t\n"
    "        spent[1] += 1\n"
    "synthesis._min_dist2 = timed\n"
    "t0 = time.perf_counter()\n"
    "runpy.run_module('backtoreality_tpu_torch.datagen.cli',"
    " run_name='__main__', alter_sys=True)\n"
    "print(f'[wall] {time.perf_counter() - t0:.3f} s, _min_dist2'"
    " f' {spent[0]:.3f} s over {spent[1]} calls')\n")


def write_ply(path, xyz):
    """A binary little-endian PLY of float xyz and uchar rgba, as ScanNet
    and Matterport meshes store their vertices."""
    import numpy as np

    rec = np.zeros(len(xyz), dtype=[("x", "<f4"), ("y", "<f4"),
                                    ("z", "<f4"), ("r", "u1"), ("g", "u1"),
                                    ("b", "u1"), ("a", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["r"] = rec["g"] = rec["b"] = 128
    rec["a"] = 255
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(xyz)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\n"
              "property uchar blue\nproperty uchar alpha\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def box_points(rng, n, dims, theta, at):
    """`n` points on the five visible faces of a box of `dims` (x, y,
    height), turned by `theta` about z, its footprint centred at `at` (x,
    y) and its bottom at z = at[2]."""
    import numpy as np

    dx, dy, dz = dims
    areas = np.array([dx * dy, dx * dz, dx * dz, dy * dz, dy * dz])
    face = rng.choice(5, n, p=areas / areas.sum())
    p = (rng.random((n, 3)) - [0.5, 0.5, 0.0]) * dims
    p[face == 0, 2] = dz
    p[face == 1, 1], p[face == 2, 1] = -dy / 2, dy / 2
    p[face == 3, 0], p[face == 4, 0] = -dx / 2, dx / 2
    c, s = np.cos(theta), np.sin(theta)
    p[:, 0:2] = p[:, 0:2] @ np.array([[c, s], [-s, c]])
    return p + at


def room_parts(rng, furniture, count, gated, rotated):
    """A room: (raw category, points) for its floor, its walls and `count`
    pieces of `furniture`, one to a cell of a 3 x 2 grid, turned by a
    random angle where `rotated`; `gated` small objects stand on the first
    piece."""
    import numpy as np

    lx, ly, lz = ROOM
    floor = np.zeros((ROOM_FLOOR_POINTS, 3))
    floor[:, 0:2] = rng.random((ROOM_FLOOR_POINTS, 2)) * [lx, ly]
    # the four walls: y = 0, x = lx, y = ly, x = 0
    side = rng.integers(0, 4, ROOM_WALL_POINTS)
    u = rng.random(ROOM_WALL_POINTS)
    wall = np.stack([np.select([side == 1, side == 3], [lx, 0.0], u * lx),
                     np.select([side == 0, side == 2], [0.0, ly], u * ly),
                     rng.random(ROOM_WALL_POINTS) * lz], 1)
    parts = [("floor", floor), ("wall", wall)]
    cells = rng.permutation(6)[:count]
    picks = rng.permutation(len(furniture))[:count]
    for k, (cell, pick) in enumerate(zip(cells, picks)):
        name, dx, dy, dz = furniture[pick]
        theta = rng.random() * np.pi if rotated else 0.0
        # the cell's centre, moved at most 0.3 m
        at = np.array([(cell % 3 + 0.5) * lx / 3,
                       (cell // 3 + 0.5) * ly / 2, 0.0])
        at[0:2] += (rng.random(2) - 0.5) * 0.6
        parts.append((name, box_points(rng, OBJECT_POINTS, (dx, dy, dz),
                                       theta, at)))
        if k == 0:
            for g, (small, sx, sy, sz) in enumerate(gated):
                spot = [at[0] + (g - 0.5) * 0.3, at[1], dz]
                parts.append((small, box_points(
                    rng, OBJECT_POINTS // 4, (sx, sy, sz), theta, spot)))
    return parts


def write_parts(stem, parts, segs_name, agg_name, align=None):
    """One mesh of `parts`: `stem`.ply (in the raw frame: `align` maps it
    to the aligned one), a segment a part in `segs_name` and an object a
    part in `agg_name`."""
    import numpy as np

    xyz = np.concatenate([p for _, p in parts])
    if align is not None:
        homo = np.concatenate([xyz, np.ones((len(xyz), 1))], 1)
        xyz = (homo @ np.linalg.inv(align).T)[:, 0:3]
    write_ply(stem.with_suffix(".ply"), xyz)
    seg = np.concatenate([np.full(len(p), i) for i, (_, p) in
                          enumerate(parts)])
    segs_name.write_text(json.dumps({"segIndices": seg.tolist()}))
    agg_name.write_text(json.dumps({"segGroups": [
        {"objectId": i, "label": name, "segments": [i]}
        for i, (name, _) in enumerate(parts)]}))


def write_scannet_scans(root, seed=0):
    """DATAGEN_SCANS scans in ScanNet's layout (`<scan>/<scan>_vh_clean_2
    .ply`, `.0.010000.segs.json`, `.aggregation.json`, and `<scan>.txt`
    with a random turn about z as its axisAlignment), named after the first
    scans of the train split: 5 or 6 pieces of furniture each, the first
    DATAGEN_GATED with a keyboard, a cup or a bottle on one."""
    import numpy as np

    from backtoreality_tpu_torch.data.config import ASSETS

    rng = np.random.default_rng(seed)
    names = (ASSETS / "scannet" / "scannetv2_train.txt").read_text().split()
    for i, scan in enumerate(names[:DATAGEN_SCANS]):
        d = root / scan
        d.mkdir(parents=True)
        gated = [GATED[i % len(GATED)]] if i < DATAGEN_GATED else []
        parts = room_parts(rng, FURNITURE, 5 + i % 2, gated, rotated=False)
        a = rng.random() * 2 * np.pi
        align = np.eye(4)
        align[0:2, 0:2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        align[0:2, 3] = rng.random(2) * 2
        write_parts(d / f"{scan}_vh_clean_2", parts,
                    d / f"{scan}_vh_clean_2.0.010000.segs.json",
                    d / f"{scan}.aggregation.json", align)
        (d / f"{scan}.txt").write_text(
            "axisAlignment = " + " ".join(map(str, align.ravel())) + "\n")
    return names[:DATAGEN_SCANS]


def write_matterport_houses(root, seed=1):
    """MP_HOUSES houses of MP_REGIONS regions in Matterport's layout
    (`house<h>/region_segmentations/region<r>.{ply,vsegs.json,
    semseg.json}`): 4 to 6 pieces of furniture a region, each turned by a
    random angle."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for h in range(MP_HOUSES):
        d = root / f"house{h}" / "region_segmentations"
        d.mkdir(parents=True)
        for r in range(MP_REGIONS):
            parts = room_parts(rng, MP_FURNITURE, 4 + (h * MP_REGIONS + r) % 3,
                               [], rotated=True)
            write_parts(d / f"region{r}", parts, d / f"region{r}.vsegs.json",
                        d / f"region{r}.semseg.json")


def datagen_cli(*args, timed=False):
    """The argv of the port's datagen CLI (`timed`: under
    DATAGEN_TIMED_CLI)."""
    head = ([sys.executable, "-c", DATAGEN_TIMED_CLI] if timed
            else [sys.executable, "-m", "backtoreality_tpu_torch.datagen.cli"])
    return head + [str(a) for a in args]


def run_datagen(argv, log):
    """One datagen command to its end; fails on a nonzero exit."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    with open(log, "w") as out:
        rc = subprocess.run(argv, cwd=ROOT, env=env, stdout=out,
                            stderr=subprocess.STDOUT,
                            timeout=DATAGEN_TIMEOUT).returncode
    secs = time.perf_counter() - t0
    require(rc == 0, f"datagen {argv[3:5]} exited {rc}:"
                     f" {pathlib.Path(log).read_text()[-2000:]}")
    return secs


def start_datagen(tmp):
    """[datagen -> br], its first half: the ScanNet scans and Matterport
    houses written, the real target domains exported
    (``export-real``; ``organize-matterport``, ``export-real-matterport``),
    then both syntheses started in processes of their own (``synthesize
    --procedural --num_aug 2 --seed 0``; ``synthesize-matterport
    --procedural --seed 0``) to run beside the phases that follow. Returns
    what :func:`datagen_br_phase` needs."""
    import atexit
    import os

    root = pathlib.Path(tmp) / "datagen"
    scans, houses = root / "scannet_scans", root / "mp_houses"
    t0 = time.perf_counter()
    names = write_scannet_scans(scans)
    write_matterport_houses(houses)
    wrote = time.perf_counter() - t0
    real = root / "scannet_train_detection_data_md40"
    mp_scans = root / "mp_scans"
    mp_real = root / "matterport_train_detection_data_md40"
    secs = {"export-real": run_datagen(datagen_cli(
        "export-real", "--scans_dir", scans, "--out", real,
        "--max_points", 50000), root / "export_real.log")}
    secs["organize-matterport"] = run_datagen(datagen_cli(
        "organize-matterport", "--houses_dir", houses, "--out", mp_scans),
        root / "organize.log")
    secs["export-real-matterport"] = run_datagen(datagen_cli(
        "export-real-matterport", "--scans_dir", mp_scans, "--out", mp_real,
        "--max_points", 50000), root / "export_real_mp.log")
    print(f"[datagen -> br] {len(names)} ScanNet scans and"
          f" {MP_HOUSES * MP_REGIONS} Matterport regions written in"
          f" {wrote:.1f} s; " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in secs.items()))
    # the source roots hold "obj": the datasets draw a virtual scan's
    # centre jitter fresh there
    jobs = {"scannet": (root / "scannet_train_detection_data_md40_obj_aug",
                        ["synthesize", "--scans_dir", scans, "--procedural",
                         "--num_aug", 2, "--seed", 0]),
            "matterport": (
                root / "matterport_train_detection_data_md40_obj_aug",
                ["synthesize-matterport", "--scans_dir", mp_scans,
                 "--procedural", "--seed", 0])}
    # one BLAS thread a process: the phases that run meanwhile keep the
    # host's other cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    running = {}
    for name, (out, args) in jobs.items():
        log = open(root / f"synthesize_{name}.log", "w+")
        proc = subprocess.Popen(
            datagen_cli(*args, "--out", out, timed=True), cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT)
        # stopped with the smoke, whatever ends it
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        running[name] = dict(proc=proc, out=out, log=log,
                             start=time.perf_counter())
    return dict(real=real, mp_real=mp_real, running=running)


def finish_synthesis(running):
    """Both syntheses to their end: {dataset: (wall s, _min_dist2 s, its
    calls, virtual scenes)}. Fails on a nonzero exit, a limit reached or
    too few scenes."""
    import re

    done = {}
    for name, job in running.items():
        left = DATAGEN_TIMEOUT - (time.perf_counter() - job["start"])
        try:
            rc = job["proc"].wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            job["proc"].kill()
            job["proc"].wait()
            rc = f"killed at its {DATAGEN_TIMEOUT} s"
        job["log"].seek(0)
        text = job["log"].read()
        job["log"].close()
        require(rc == 0, f"synthesize ({name}) exited {rc}: {text[-2000:]}")
        timed = re.search(r"\[wall\] ([0-9.]+) s, _min_dist2 ([0-9.]+) s"
                          r" over (\d+) calls", text)
        require(timed is not None, f"synthesize ({name}): no [wall] line")
        scenes = sorted(p.name[:-len("_vert.npy")]
                        for p in job["out"].glob("*_vert.npy"))
        require(len(scenes) >= DATAGEN_MIN_SCENES[name],
                f"synthesize ({name}): {len(scenes)} virtual scenes, fewer"
                f" than {DATAGEN_MIN_SCENES[name]}")
        done[name] = (float(timed[1]), float(timed[2]), int(timed[3]),
                      scenes)
    return done


def datagen_br_phase(started, tmp, counters, header):
    """[datagen -> br], its second half: both syntheses awaited (their
    walls and _min_dist2's share printed), then ``votenet_br.main`` at
    VoteNet's widths (B=8, N=40000, --fps_candidates 8192) on each export
    as the target and its synthesis as the source: ScanNet one epoch of 2
    steps, Matterport (``--dataset matterport_md40``: rotated boxes, 12
    heading bins) two epochs of one; one evaluation each, the launches
    checked, finite losses and mAP. Then one serving forward of the
    ScanNet BR model (``evaluate``'s ``--kind da`` graph from
    ``train_BR.tar``) through ``eval.dump_helper.dump_results``. Returns
    the launches by path."""
    import numpy as np
    import torch

    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.data.dataset import DetectionDataset
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.eval.dump_helper import dump_results
    from backtoreality_tpu_torch.train import common, evaluate, votenet_br

    t0 = time.perf_counter()
    synth = finish_synthesis(started["running"])
    for name, (wall, dist, calls, scenes) in synth.items():
        print(f"[datagen -> br] synthesize ({name}): {len(scenes)} virtual"
              f" scenes in {wall:.1f} s of its process, _min_dist2"
              f" {dist:.1f} s ({dist / wall:.3f} of it) over {calls} calls")
    print(f"  waited {time.perf_counter() - t0:.1f} s for them here")
    tmp = pathlib.Path(tmp)
    launches = {}
    cases = ((DATAGEN_PATHS[0], "scannet_md40", started["real"],
              started["running"]["scannet"]["out"], 1),
             (DATAGEN_PATHS[1], "matterport_md40", started["mp_real"],
              started["running"]["matterport"]["out"], 2))
    for path, dataset, real, source, epochs in cases:
        cfg = get_config(dataset)
        sizes = [len(DetectionDataset(cfg, root, split=split,
                                      num_points=N))
                 for root, split in ((source, "train_aug"), (real, "all"))]
        steps = epochs * min(s // B for s in sizes)
        evals = math.ceil(sizes[1] / B)
        require(steps == 2, f"{path}: {sizes} source and target scenes"
                            f" make {steps} steps, not 2")
        log = tmp / f"{path}_log"
        reset(counters)
        t0 = time.perf_counter()
        votenet_br.main([
            "--dataset", dataset, "--data_root", str(real),
            "--source_data_root", str(source), "--train_split", "all",
            "--val_split", "all", "--log_dir", str(log), "--device", "cuda",
            "--num_point", str(N), "--batch_size", str(B),
            "--fps_candidates", "8192", "--max_epoch", str(epochs),
            "--eval_freq", str(epochs)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[path] = read_counts(counters)
        print(f"[datagen -> br] votenet_br.main --dataset {dataset}:"
              f" {sizes[0]} virtual and {sizes[1]} real scenes, {steps}"
              f" steps + one evaluation in {secs:.1f} s; launches"
              f" {launches[path]}")
        check_counts(path, launches[path], "da", 2 * steps + evals, steps,
                     evals)
        rows = [json.loads(line) for line in
                (log / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in rows if "loss" in r]
        maps = [r["mAP"] for r in rows if "mAP" in r]
        require(len(losses) == epochs and len(maps) == 1
                and all(map(math.isfinite, losses + maps)),
                f"{path}: loss {losses}, mAP {maps}")
        print(f"  epoch losses {', '.join(f'{v:.4f}' for v in losses)},"
              f" eval mAP@0.25 {maps[0]:.4f}")

    # one serving forward of the ScanNet BR model, dumped
    cfg = get_config("scannet_md40")
    flags = evaluate.add_common_flags(argparse.ArgumentParser()).parse_args(
        [])
    model = evaluate.build_model(flags, cfg, "da")
    common.restore_weights(model, tmp / f"{DATAGEN_PATHS[0]}_log"
                           / "train_BR.tar", "--kind da")
    model.cuda().eval()
    ds = DetectionDataset(cfg, started["real"], split="all", num_points=N,
                          use_height=True)
    batch = next(iter(DetectionDataLoader(ds, B, shuffle=False, prefetch=0)))
    with torch.inference_mode():
        ep = model(*(torch.from_numpy(a).cuda()
                     for a in common.model_args(batch, False)))
    end_points = {k: v.cpu().numpy() for k, v in ep.items()
                  if torch.is_tensor(v)}
    end_points.update(batch)
    dump = tmp / "datagen_br_dump"
    t0 = time.perf_counter()
    dump_results(end_points, str(dump), cfg)
    names = {p.name for p in dump.iterdir()}
    want = {"000000_pc.ply", "000000_pred_confident_nms_bbox.ply",
            "000000_gt_bbox.ply"}
    require(want <= names, f"dump_results: {sorted(want - names)} missing")
    print(f"[datagen -> br] dump_results: {len(names)} PLYs for {B} scenes"
          f" in {time.perf_counter() - t0:.1f} s  | {header}")
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
# gradients by about 1% (PERF.md, section 6). The ball query is not among
# those choices: its kernel decides a row's slots alike in every tile, so
# a rank's 4 rows get the slots they get among 8 ([ball query tiles]).
# So the step is compared twice. As it runs: the loss, all gradients as
# one vector and all BN buffers as one, each relative to its norm, within
# DP_TOL or DP_NOISE times that reversal's error. With the choices pinned
# (Pinned: world 1's replayed in world 2 and in the reversal): every
# tensor within DP_TOL of its largest magnitude, or DP_NOISE times the
# reversal's error of that tensor where rounding alone parts it further
# (dp_pinned_error)
DP_TOL = 1e-4
DP_NOISE = 4
DP_TIMEOUT = 600  # seconds for a pair of ranks or of trainer processes
DP_CASES = (("votenet_fsb", "plain", 1), ("votenet_br", "da", 2),
            ("gf_fsb", "gf", 1))


class Pinned:
    """The discrete choices of a train step, recorded in one run and
    replayed in another: every ReLU's mask (``torch.relu``), every
    max-pool's winner over a group's samples (``torch.amax`` over axis 2
    of a (B, M, S, C) tensor), GroupFree3D's top-k queries and every
    ``nn_distance`` nearest neighbour of the criteria. A choice whose
    inputs lie within rounding of a tie (a pre-activation at 0, two
    samples' features, two distances) flips when the order of a sum
    changes, and each flip moves a whole term of the gradient. Replayed,
    two runs part by rounding alone. The ball query runs live: its slots
    follow a row's own coordinates, in any tile. Recording computes the
    replay's function (a mask product, a gather at the winner), so the two
    runs are the same function. Rows are the first axis of every choice: a
    replay takes the recorded rows in reverse (`reverse`) and, on a tensor
    with fewer rows than recorded, this rank's share of them (a rank's
    forward; a criterion sees the gathered global batch)."""

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

        from backtoreality_tpu_torch.losses import groupfree as gf_losses
        from backtoreality_tpu_torch.losses import votenet as vote_losses
        from backtoreality_tpu_torch.models.groupfree import detector

        return ((torch, "relu", self._relu), (torch, "amax", self._amax),
                (detector, "top_k_indices", self._top_k),
                (vote_losses, "nn_distance", self._nn_distance),
                (gf_losses, "nn_distance", self._nn_distance))

    def __enter__(self):
        self.k = 0
        self.real, self.saved = {}, []
        for module, attr, fn in self._sites():
            self.saved.append((module, attr, getattr(module, attr)))
            setattr(module, attr, fn)
        self.real = {"amax": self.saved[1][2], "top_k": self.saved[2][2]}
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
    from backtoreality_tpu_torch.ops import bn_relu, fps, grouping
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
                    grouping.LOCALIZE, ball_query.EXACT, bn_relu.KERNEL)
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
        procs.append(_spawn([sys.executable, "-m",
                             f"backtoreality_tpu_torch.train.{module}",
                             *args], env, cwd))
    return procs


def _spawn(cmd, env, cwd):
    """`cmd` started, its output to a file (`out_file`, read by `_wait`),
    not a pipe: a process that runs beside another is read only when that
    one is done."""
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    proc.out_file = out
    return proc


def start_contract(module, args, cwd):
    """The two --multihost processes of a contract, started: a dict of the
    module, its arguments, the processes and the start time."""
    return dict(module=module, args=args, start=time.perf_counter(),
                procs=_launch_pair(module, args + ["--multihost"], cwd))


def _wait(procs, timeout=DP_TIMEOUT):
    """Every process's (exit code, output) within `timeout` seconds; all
    are killed at it."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            p.out_file.seek(0)
            outs.append((p.returncode, p.out_file.read()))
            p.out_file.close()
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


def dp_contract(job, log, epochs):
    """The JAX package's two-process contract (tests/test_multiprocess.py)
    for the pair `job` (`start_contract`) at --multihost world 2 on the
    card: both ranks exit 0 and log the same loss every epoch, one set of
    checkpoints (rank 0's), the rank-1 log, and an evaluation in both
    logs. Returns its seconds."""
    module, args = job["module"], job["args"]
    for rc, out in _wait(job["procs"]):
        require(rc == 0, f"{module} --multihost: a rank exited {rc}:\n"
                f"{out[-3000:]}")
    secs = time.perf_counter() - job["start"]
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

    # the JAX package's multi-process contract, on the 16-scan fixtures:
    # votenet_br's and gf_fsb's pairs run beside votenet_fsb's and its
    # resume (each a group of its own; the contract times nothing)
    per_process = str(B // DP_WORLD)
    vote = ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--num_point", str(N), "--batch_size",
            per_process, "--fps_candidates", "8192"]
    fsb, br, gf = tmp / "dp_fsb", tmp / "dp_br", tmp / "dp_gf"
    br_args = vote + ["--log_dir", str(br), "--source_data_root",
                      str(virtual), "--max_epoch", "1", "--eval_freq", "1"]
    gf_args = ["--data_root", str(gf_scans), "--train_split", "all",
               "--val_split", "all", "--batch_size", per_process,
               "--log_dir", str(gf), "--max_epoch", "1", "--val_freq", "1"]
    br_job = start_contract("votenet_br", br_args, tmp)
    gf_job = start_contract("gf_fsb", gf_args, tmp)
    try:
        dp_contract(start_contract("votenet_fsb", vote + [
            "--log_dir", str(fsb), "--max_epoch", "2", "--eval_freq", "2"],
            tmp), fsb, range(2))
        require(sorted(p.name for p in fsb.glob("*.tar"))
                == ["checkpoint.tar"], "votenet_fsb: one checkpoint")
        dp_contract(start_contract("votenet_fsb", vote + [
            "--log_dir", str(fsb), "--max_epoch", "3", "--eval_freq", "1",
            "--resume", "--checkpoint_path", str(fsb / "checkpoint.tar")],
            tmp), fsb, range(3))
        dp_contract(br_job, br, range(1))
        require(sorted(p.name for p in br.glob("*.tar"))
                == ["train_BR.tar"], "votenet_br: one checkpoint")
        dp_contract(gf_job, gf, range(1))
        require(sorted(p.name for p in gf.glob("*.tar"))
                == ["ckpt_epoch_0.tar", "ckpt_epoch_last.tar"],
                "gf_fsb: one set of checkpoints")
    finally:
        for p in br_job["procs"] + gf_job["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait()
    return paths


def preemption_phase(scans, tmp, header):
    """``[preemption]`` (a child, beside the learning check): ``votenet_fsb``
    in a process of its own with ``--guard_every_steps 1`` (B=8: 2 steps
    an epoch, 30 epochs), sent SIGTERM once its first checkpoint is
    written: it must exit with 143 having written the guard's newest
    snapshot, saved as the last epoch it completed (E), after 2E + 2 to
    2E + 4 steps (a snapshot after a step of epoch E + 1 counts as epoch
    E: a resume re-runs that epoch); its parameters must equal bitwise the
    state after as many steps replayed here (the steps are
    deterministic); ``--resume`` then re-runs epoch E + 1 and finishes.
    Returns the epoch and steps of the snapshot."""
    import os
    import signal

    import torch

    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.data.loader import DetectionDataLoader
    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.train import common, votenet, votenet_fsb

    tmp = pathlib.Path(tmp)
    log = tmp / "preempt"
    args = ["--data_root", str(scans), "--train_split", "all",
            "--val_split", "all", "--device", "cuda", "--num_point", str(N),
            "--batch_size", str(B), "--fps_candidates", "8192",
            "--eval_freq", "100"]
    run = args + ["--log_dir", str(log), "--guard_every_steps", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "backtoreality_tpu_torch.train.votenet_fsb"]
    proc = _spawn(cmd + run + ["--max_epoch", "30"], env, tmp)
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
    (rc, out), = _wait([_spawn(
        cmd + run + ["--max_epoch", str(epoch + 2), "--resume",
                     "--checkpoint_path", str(log / "checkpoint.tar")],
        env, tmp)])
    require(rc == 0 and f"epoch {epoch + 1:03d}" in out
            and common.load_checkpoint(log / "checkpoint.tar")["epoch"]
            == epoch + 1, f"preemption: --resume exited {rc}:\n{out[-3000:]}")
    print(f"[preemption] --resume re-ran epoch {epoch + 1} and finished")
    return dict(epoch=epoch, steps=steps)


def guard_phase(scans, gf_scans, tmp, header):
    """``[preemption] guard.update``: the time of one ``guard.update`` (a
    host snapshot of the model and optimizer, the step's pause) for
    VoteNet's state at the bench configuration (Adam, one step taken) and
    GroupFree3D's at its CLI defaults (AdamW, one step taken)."""
    import torch

    from backtoreality_tpu_torch.data import get_config
    from backtoreality_tpu_torch.losses import groupfree as gf_losses
    from backtoreality_tpu_torch.losses import votenet as vote_losses
    from backtoreality_tpu_torch.train import common, groupfree, votenet

    cfg = get_config("scannet_md40")
    flags = votenet.add_common_flags(argparse.ArgumentParser()).parse_args(
        ["--fps_candidates", "8192"])
    torch.manual_seed(0)
    model = votenet.build_model(flags, cfg).cuda()
    opt = common.make_optimizer(model.parameters(), "adam", lr0=1e-3)
    votenet.make_train_step(model, opt, vote_losses.get_loss, cfg)(
        first_batch(cfg, scans, "all"), 0.5)
    gflags = gf_flags()
    torch.manual_seed(0)
    gf = groupfree.build_model(gflags, cfg).cuda()
    gopt = common.make_gf_optimizer(gf, lambda c: 1e-4, lambda c: 1e-5)
    groupfree.make_train_step(gf, gopt, gf_losses.get_loss, cfg,
                              groupfree.loss_kwargs(gflags))(
        gf_first_batch(gf_scans, cfg, use_height=False), gflags.bn_momentum)
    guard = common.PreemptionGuard(pathlib.Path(tmp) / "guard.tar")
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
    parser.add_argument("--child", nargs=2, metavar=("NAME", "DIR"),
                        help="run only phase NAME (pairs, preemption or"
                             " gf_sweep) on DIR/input.json, writing what"
                             " it returns to DIR/output.json (the full run"
                             " starts these in processes of their own)")
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
    from backtoreality_tpu_torch.ops import _build, bn_relu
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
    counters = kernels + (grouping.LOCALIZE, bq.EXACT, bn_relu.KERNEL)
    if args.child:
        run_child(args.child[0], pathlib.Path(args.child[1]), counters,
                  header)
        return 0

    # each phase's seconds, printed at the end
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all(kernels + (bn_relu.KERNEL,))
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
    for label, x, _, c, r, s in sa_calls + (ctjt,):
        check_bq_tiles(label, x, c, r, s, bq)
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
    # without features: the coordinates alone; at SA1 as tools/mfu.py's
    # VoteNet (no height feature) runs it
    _, x, _, c, r, s = sa_calls[2]
    check_localize("sa3_xyz_only", x, None, c, r, s, bq, grouping, reps=0)
    _, x, _, c, r, s = sa_calls[0]
    fwd, _ = check_localize("sa1_xyz_only", x, None, c, r, s, bq, grouping,
                            reps=3)
    local_fwd.append(fwd)
    check_half_refused(ep["sa1_xyz"], ep["sa1_features"], ep["sa2_xyz"],
                       fps, bq, grouping, counters)
    # the exact query at the five layers' inputs of this forward, in their
    # layout (SA1's xyz: the first 3 of each point's 4 values), held in
    # [exact query]
    layer_exact = [(f"layers {label}", x, c, r, s, False, None)
                   for label, x, _, c, r, s in sa_calls]
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
    bn_records, bn_summary = bn_relu_phase(model, pc, gf_scans, cfg, device)
    lap("kernels")
    if args.kernels_only:
        print(json.dumps({"kernels_only": {
            "bn_relu": bn_records, "bn_relu_forwards": bn_summary,
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
    check_counts("serving", serving, "plain", batches, 0, batches)
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
    paths["jitter_diag"], shapes = jitter_diag_phase(scans, tmp.name, cfg,
                                                     counters, header)
    tool_shapes = {"jitter_diag": shapes}
    lap("jitter_diag")
    launches, shapes = random_sampling_phase(scans, virtual, tmp.name,
                                             counters)
    paths.update(launches)
    tool_shapes.update(shapes)
    lap("cluster sampling random")
    da_step_phase(scans, virtual, cfg, header)
    lap("votenet da steps")
    paths["training_bf16"] = bf16_phase(scans, tmp.name, cfg, counters,
                                        header, fsb_f32, fps, bq, grouping)
    lap("votenet bf16")
    val, matching = gate_phase(tmp.name, counters)
    lap("checkpoint gate")
    native_eval_phase(matching, header)
    del matching
    lap("native eval")
    gate_bf16_phase(val, tmp.name, counters, lap)
    (surface, shapes, surface_bq, surface_fwd, surface_bwd,
     boxnet_step) = model_surface_phase(scans, virtual, cfg, counters,
                                        header, fps, bq, grouping)
    paths.update(surface)
    bq_records += surface_bq
    local_fwd += surface_fwd
    local_bwd += surface_bwd
    records = {
        "fps": fps_records, "ball_query": bq_records, "localize": local_fwd,
        "localize_backward": local_bwd, "group": group_fwd,
        "group_backward": group_bwd}
    tag_paths(shapes, records)
    lap("model surface")
    launches, shapes, _ = mfu_phase(counters, header)
    paths.update(launches)
    tool_shapes.update(shapes)
    tag_paths(tool_shapes, records)
    lap("mfu")

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
    # 8. --query_mode exact: the reference's inits imported, both detectors
    # served from them (timed, before anything runs beside them), then the
    # exact query's kernel held to its plain version at the inputs those
    # forwards gave it (f64 too at VoteNet's SA1 and SA3) and on the edge
    # clouds
    inits = torch_import_phase(tmp.name)
    lap("torch_import")
    launches, exact_shapes, exact_inputs = exact_serving_phase(
        scans, gf_scans, inits, cfg, counters, header)
    paths.update(launches)
    lap("serving exact")
    print(f"[exact query] the kernel (ops.ball_query on the card) at the"
          f" exact servings' inputs, against the plain version; K3 at the"
          f" same shape  | {header}")
    f64_at = {(N, 2048, 64), (1024, 512, 16)}  # (N, M, S) of SA1 and SA3
    exact_records = exact_query_phase(
        [(f"serving {d[:4]}", x, c, r, k, d[1:4] in f64_at, None)
         for d, (x, c, r, k) in sorted(exact_inputs.items())], bq, reps=5)
    print("[exact query] the edge clouds (exact_edge_clouds), float32 and"
          " float64")
    print("[exact query] the kernel at the five layers' inputs of the"
          " stratified serving forward ([kernels]), checked, not timed")
    layer_records = exact_query_phase(layer_exact, bq, reps=0)
    edges = exact_edge_calls(device)
    layer_records += exact_query_phase(edges, bq, reps=0)
    check_exact_half(bq, edges)
    lap("exact query")
    # the round-5 parity pairs and [datagen -> br]'s syntheses in processes
    # of their own, beside the learning check and votenet_br on the
    # syntheses, which time no step
    pairs = start_child(tmp.name, "pairs", {"inits": {
        k: str(v) for k, v in inits.items()}})
    datagen = start_datagen(tmp.name)
    preemption = start_child(tmp.name, "preemption", {"scans": str(scans)})
    sweep = start_child(tmp.name, "gf_sweep", {"scans": str(gf_scans)})
    lap("datagen start")
    gf_learning_check(tmp.name, counters)
    lap("gf learning check")
    paths.update(datagen_br_phase(datagen, tmp.name, counters, header))
    lap("datagen br")
    paths["gf_sweep"] = finish_child(sweep, SWEEP_TIMEOUT)["launches"]
    lap("gf sweep")
    pairs = finish_child(pairs, PAIRS_TIMEOUT)
    paths.update(pairs["launches"])
    for path, shapes in pairs["shapes"].items():
        exact_shapes[path] = {(kind, tuple(dims)) for kind, dims in shapes}
    lap("parity pairs")
    finish_child(preemption, PREEMPTION_TIMEOUT)
    lap("preemption")
    # the pairs' inputs to the exact query, timed now that nothing runs
    # beside it, at the dims the servings did not hold
    held = {tuple(r["dims"]) for r in exact_records}
    print(f"[exact query] the kernel at the parity pairs' inputs  | {header}")
    exact_records += exact_query_phase(
        [(f"pairs {d[:4]}", same_layout(x, device), same_layout(c, device),
          r, k, False, None)
         for d, (x, c, r, k) in sorted(torch.load(
             pairs["inputs"], weights_only=True).items())
         if d not in held], bq, reps=5)
    tag_paths({path: {(kind, dims) for kind, dims in shapes
                      if kind == "ball_query_exact"}
               for path, shapes in exact_shapes.items()},
              {"ball_query_exact": exact_records})
    lap("exact query pairs")

    # 10. data parallelism, the guard's snapshot time, the profiler window
    paths.update(dp_phase(scans, virtual, gf_scans, tmp.name, counters,
                          header))
    lap("data parallel")
    guard_phase(scans, gf_scans, tmp.name, header)
    lap("guard")
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
        backward = k["name"].endswith("_backward")
        surface = SURFACE_TRAINING + TOOL_TRAINING + (
            () if backward else SURFACE_SERVING + TOOL_SERVING)
        require(all(k["launches_by_path"][p] > 0
                    for p in TRAINING + GF_TRAINING + BF16_TRAINING
                    + DP_PATHS + surface + ("gf_sweep",)),
                f"{k['name']}: not launched on every training path")
        checked = {p for r in k["per_shape"] for p in r.get("paths", ())}
        want = set(DP_PATHS + surface)
        require(want <= checked, f"{k['name']}: no check against"
                f" the plain version at {want - checked}'s shapes")
    # the exact query's kernel: its times on the VoteNet exact serving
    # path; launched on every exact path and on no other
    exact = summarize("ball_query_exact", bq.EXACT,
                      "backtoreality_tpu_torch/csrc/ball_query.cu",
                      exact_records + layer_records,
                      by_path("ball_query_exact"),
                      "serving_exact")
    exact_paths = {"serving_exact", "gf_serving_exact",
                   *(f"pair_{p}" for p in PAIRS)}
    launched = {p for p, n in exact["launches_by_path"].items() if n}
    require(launched == exact_paths, f"ball_query_exact: launched on"
            f" {sorted(launched)}, expected {sorted(exact_paths)}")
    checked = {p for r in exact_records for p in r.get("paths", ())}
    require(exact_paths <= checked, f"ball_query_exact: no check against"
            f" the plain version at {exact_paths - checked}'s shapes")
    kernels_line.append(exact)
    # the eval BatchNorm + ReLU kernel: its times a VoteNet serving forward;
    # launched on every path that evaluates (check_counts holds each to
    # its BatchNorms times its evaluation forwards) and on no other
    bn_launches = by_path("bn_relu")
    evaluating = {p for p, n in bn_launches.items() if n}
    require({"serving", "gf_serving", "serving_exact", "gf_serving_exact",
             "training", "training_bf16", "gf_fsb_bf16"} <= evaluating
            and not evaluating & {"mfu_votenet", "mfu_gf",
                                  "surface_variants", "da_separate",
                                  "da_jitter2"},
            f"bn_relu: launched on {sorted(evaluating)}")
    kernels_line.append({
        "name": "bn_relu", "route": "cuda",
        "source": "backtoreality_tpu_torch/csrc/bn_relu.cu",
        "replaces": bn_relu.KERNEL.replaces,
        "launches": bn_launches["serving"],
        "launches_by_path": bn_launches,
        "max_abs_err": 0.0, **{k: bn_summary["serving"][k] for k in (
            "ms", "plain_ms", "bound_ms")}, "bound_by": "bytes",
        "forwards": bn_summary, "per_shape": bn_records})
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
