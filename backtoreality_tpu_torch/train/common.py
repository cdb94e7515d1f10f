"""Shared training machinery: device, launch, schedules, optimizers,
checkpoints, the preemption guard, logging.

Counterpart of the parts of ``backtoreality_tpu/train/common.py`` that
the ported recipes use: the reference's epoch-step learning rate and BN
momentum schedules, GroupFree3D's per-iteration warmup, step and cosine
schedule, Adam/AdamW with optax's defaults and an optional global-norm
clip in optax's formula, GroupFree3D's AdamW with a decoder learning rate
of its own, atomic checkpoints of the model and optimizer, the
cross-stage partial restore (BR weights grafted into CenterRefine, the
JAX package's checkpoints into the port), a metric meter and the
rank-aware train logger.

Data parallelism (:func:`launch`): ``--num_devices N`` spawns N local
ranks that split each global batch by rows; ``--multihost`` joins the
process group the environment describes (``BTR_COORDINATOR``,
``BTR_NUM_PROCESSES``, ``BTR_PROCESS_ID``, else torchrun's variables),
each rank reading its own loader shard. Either way every rank computes
the global batch's BN moments and loss (``parallel``), :func:`update`
sums the gradients over the ranks before the optimizer step (and so
before GroupFree3D's clip), and only rank 0 writes checkpoints and the
config. :class:`PreemptionGuard` writes a host snapshot of the model and
optimizer on SIGTERM. The JAX package's ``enable_compilation_cache`` has
no counterpart: the kernels are built once, at first use.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import logging
import math
import os
import pathlib
import re
import signal
import sys
import time
import typing as tp

import numpy as np
import torch

from backtoreality_tpu_torch import bridge, parallel
from backtoreality_tpu_torch.nn.norm import (bn_momentum_schedule,
                                             set_bn_momentum)
from backtoreality_tpu_torch.train.observability import span


def resolve_device(name: str | None) -> torch.device:
    """`name`, or cuda when None. Raises when cuda is asked for (or
    implied) and no card is present: never falls back to the CPU."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass"
                               " --device cpu to run on the CPU")
        # the JAX geometry and matmuls run at full f32 precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


# ---------------------------------------------------------------------------
# Launch: one process, N spawned local ranks, or one rank of a group
# ---------------------------------------------------------------------------


def add_parallel_flags(parser):
    """The operations flags of the JAX trainers, with their names,
    defaults and help."""
    parser.add_argument("--num_devices", type=int, default=None,
                        help="local devices to train on, one spawned rank"
                             " each, splitting every --batch_size batch by"
                             " rows (default: every visible card; 1 with"
                             " --device cpu)")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group the environment"
                             " describes (BTR_COORDINATOR,"
                             " BTR_NUM_PROCESSES, BTR_PROCESS_ID, else"
                             " torchrun's MASTER_ADDR/MASTER_PORT/RANK/"
                             "WORLD_SIZE); --batch_size is per process")
    parser.add_argument("--guard_every_steps", type=int, default=100,
                        help="mid-epoch preemption-snapshot cadence in"
                             " steps (0 disables; each snapshot is a"
                             " blocking full-state host copy)")
    parser.add_argument("--profile_dir", default=None,
                        help="torch.profiler trace dir (traces host steps"
                             " 10-15 of the run)")
    parser.add_argument("--ram_cache_gb", type=float, default=8.0,
                        help="per-dataset RAM cache budget for raw scan"
                             " arrays (0 disables caching)")
    return parser


def cache_kw(flags) -> dict:
    """The datasets' RAM cache from ``--ram_cache_gb`` (0 turns it off)."""
    if flags.ram_cache_gb <= 0:
        return dict(ram_cache=False)
    return dict(ram_cache=True, ram_cache_bytes=int(flags.ram_cache_gb
                                                    * 2**30))


def num_devices(flags) -> int:
    """``--num_devices``, by default every visible card (1 with --device
    cpu). More than the visible cards raises: no device is dropped
    silently."""
    on_cpu = flags.device is not None and torch.device(
        flags.device).type == "cpu"
    visible = 0 if on_cpu or not torch.cuda.is_available() else (
        torch.cuda.device_count())
    n = flags.num_devices
    if n is None:
        return 1 if on_cpu else max(visible, 1)
    if n < 1 or (not on_cpu and n > visible):
        raise ValueError(f"--num_devices {n}, but {visible} CUDA device(s)"
                         " are visible")
    return n


def init_multihost(device_name: str | None) -> torch.device:
    """Join the process group the environment describes (the JAX
    package's ``init_multihost``): ``BTR_NUM_PROCESSES``,
    ``BTR_PROCESS_ID`` (default 0) and ``BTR_COORDINATOR`` (host:port),
    else torchrun's ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``. A group of one needs no address. The rank's device
    is the CPU with ``--device cpu``, else ``cuda:LOCAL_RANK``, or
    without ``LOCAL_RANK`` the rank modulo the visible cards. The backend
    follows the processes on this host (:func:`local_processes`).
    Returns the device."""
    env = os.environ
    if "BTR_NUM_PROCESSES" in env:
        world = int(env["BTR_NUM_PROCESSES"])
        rank = int(env.get("BTR_PROCESS_ID", "0"))
        address = env.get("BTR_COORDINATOR")
    elif "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    else:
        raise RuntimeError("--multihost needs BTR_NUM_PROCESSES (and"
                           " BTR_PROCESS_ID, BTR_COORDINATOR) or torchrun's"
                           " WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT")
    if address is None:
        if world != 1:
            raise RuntimeError("--multihost: BTR_COORDINATOR (host:port)"
                               f" is needed for {world} processes")
        address = f"127.0.0.1:{parallel.free_port()}"
    device = resolve_device(device_name)
    if device.type == "cuda":
        index = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    parallel.init(rank, world, address, device, local_processes())
    return device


def local_processes() -> int:
    """The group's processes on this host, as the environment states it:
    ``LOCAL_WORLD_SIZE`` (torchrun sets it), else ``BTR_LOCAL_PROCESSES``,
    else 1 (a process a host). More of them than visible cards share a
    card, and the group then runs over gloo (``parallel.backend``)."""
    env = os.environ
    return int(env.get("LOCAL_WORLD_SIZE",
                       env.get("BTR_LOCAL_PROCESSES", "1")))


def launch(run, flags, *args):
    """Run ``run(flags, device, *args)`` as the flags ask, and return what
    it returns; with several spawned ranks, None (the trained state is in
    rank 0's checkpoint).

    * ``--multihost``: this process is one rank of the group the
      environment describes (:func:`init_multihost`).
    * ``--num_devices N``, N > 1: N local ranks are spawned, rank r on
      ``cuda:r`` (or the CPU with ``--device cpu``), each re-entering
      `run`; every rank reads the whole global batch and keeps its rows.
    * Otherwise this process alone, with no process group: the run is the
      single-device run, bit for bit.
    """
    if flags.multihost:
        device = init_multihost(flags.device)
        try:
            return run(flags, device, *args)
        finally:
            parallel.shutdown()
    n = num_devices(flags)
    if n == 1:
        return run(flags, resolve_device(flags.device), *args)
    if flags.batch_size % n:
        raise ValueError(f"--batch_size {flags.batch_size} does not split"
                         f" over --num_devices {n}")
    spawn(_rank_main, n, run, flags, args)
    return None


def _rank_main(rank, world, address, run, flags, args):
    """One spawned rank of :func:`launch`."""
    make_deterministic()
    if flags.device is not None and torch.device(flags.device).type == "cpu":
        device = torch.device("cpu")
    else:
        device = resolve_device(f"cuda:{rank}")
        torch.cuda.set_device(device)
    parallel.init(rank, world, address, device, world)
    try:
        run(flags, device, *args)
    finally:
        parallel.shutdown()


def spawn(fn, nprocs: int, *args, timeout: float | None = None,
          meanwhile=None):
    """Run ``fn(rank, nprocs, address, *args)`` in `nprocs` processes
    (the ``spawn`` start method: CUDA does not survive a fork), `address`
    a free localhost port for the group's rendezvous, and return what
    ``meanwhile()`` returns, called here while they run (None without
    it). SIGTERM sent to this process is passed on to every rank (each
    one's guard saves, on rank 0). A rank that exits nonzero has the
    others terminated, and this process raises SystemExit with its exit
    code; ranks that outlast `timeout` seconds are killed, and it raises
    SystemExit(124)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    address = f"127.0.0.1:{parallel.free_port()}"
    procs = [ctx.Process(target=fn, args=(r, nprocs, address, *args))
             for r in range(nprocs)]
    deadline = None if timeout is None else time.monotonic() + timeout
    for p in procs:
        p.start()

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                p.terminate()

    previous = signal.signal(signal.SIGTERM, forward)
    try:
        result = meanwhile() if meanwhile else None
        while True:
            failed = [p.exitcode for p in procs if p.exitcode]
            if failed or all(p.exitcode == 0 for p in procs):
                break
            if deadline is not None and time.monotonic() > deadline:
                print(f"ranks killed at the {timeout} s limit",
                      file=sys.stderr)
                raise SystemExit(124)
            time.sleep(0.2)
        if failed:
            forward(None, None)
            for p in procs:
                p.join()
            # a rank killed by signal s reports -s; a shell reports 128 + s
            raise SystemExit(failed[0] if failed[0] > 0 else 128 - failed[0])
        return result
    finally:
        signal.signal(signal.SIGTERM, previous)
        for p in procs:  # still running only if this process failed
            if p.is_alive():
                p.kill()
            p.join()


def make_deterministic():
    """Make every step bitwise repeatable, as the JAX package's steps are
    (XLA's scatter-adds, no atomics): cuBLAS with a fixed workspace, and
    ``torch.use_deterministic_algorithms``, under which the backwards of
    the gathers take PyTorch's sorted scatter-add and any op without a
    deterministic CUDA path raises, naming itself. cuBLAS reads
    ``CUBLAS_WORKSPACE_CONFIG`` when it makes its first handle, so this
    runs before any CUDA work; a value already set is kept (torch refuses
    one that is not deterministic). The mode's NaN fill of every new
    tensor is left off: no op here reads memory it did not write, and the
    fill costs kernel time in every step (``chip_smoke.py`` times it)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def compute_dtype(flags) -> torch.dtype | None:
    """The model's compute dtype: bfloat16 with ``--bf16`` (float32
    parameters and statistics), else None (the parameters' float32)."""
    return torch.bfloat16 if flags.bf16 else None


def recal_batches(flags) -> int:
    """``--bn_recal_batches``, or by default 20 with ``--bf16`` and 0
    without."""
    if flags.bn_recal_batches is not None:
        return flags.bn_recal_batches
    return 20 if flags.bf16 else 0


def to_device(batch: dict, device) -> dict:
    """Host batch (numpy arrays) -> tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def model_args(batch, jitter: bool) -> tuple:
    """The model's inputs from a batch: the point clouds, and for the
    jitter models also the centre and class labels."""
    if jitter:
        return (batch["point_clouds"], batch["center_label"],
                batch["sem_cls_label"])
    return (batch["point_clouds"],)


def draw_generator(device, *key: int) -> torch.Generator:
    """A generator on `device` seeded from the integers `key` alone (a
    hash of them, as ``jax.random.fold_in`` folds a step into a key): the
    draws of ``--cluster_sampling random``. The global RNG is neither read
    nor advanced."""
    digest = hashlib.sha256(repr(tuple(int(k) for k in key)).encode())
    seed = int.from_bytes(digest.digest()[:8], "little")
    return torch.Generator(device=device).manual_seed(seed)


def optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """The updates `optimizer` has taken: the largest per-parameter
    ``step`` of its state (Adam's, AdamW's), which travels in its
    state_dict, so a resumed run goes on counting; 0 before the first."""
    steps = [int(s["step"]) for s in optimizer.state.values() if "step" in s]
    return max(steps, default=0)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def step_lr(base_lr: float, decay_steps: tp.Sequence[int],
            decay_rates: tp.Sequence[float]):
    """Reference epoch-step decay (`train_Votenet_FSB.py:191-201`):
    lr = base * prod(rate_i for step_i <= epoch)."""

    def schedule(epoch: int) -> float:
        lr = base_lr
        for s, r in zip(decay_steps, decay_rates):
            if epoch >= s:
                lr *= r
        return lr

    return schedule


def bn_momentum_fn(init=0.5, step=20, rate=0.5, floor=0.001):
    """`train_Votenet_FSB.py:91-95,186-189`: epoch -> BN momentum."""
    return functools.partial(bn_momentum_schedule, init=init,
                             decay_step=step, decay_rate=rate, floor=floor)


def make_gf_schedule(base_lr: float, flags, steps_per_epoch: int):
    """The reference GF scheduler (`utils/lr_scheduler.py:65-87`) as the
    JAX package's optax schedule of the update count: an optional linear
    warmup from base / multiplier, then per-iteration MultiStep or cosine
    decay. Returns f(count) -> lr."""
    warmup_epochs = max(flags.warmup_epoch, 0)
    warmup = warmup_epochs * steps_per_epoch
    if flags.lr_scheduler == "step":
        bounds = sorted((m - warmup_epochs) * steps_per_epoch
                        for m in flags.lr_decay_epochs)

        def after(count):
            return base_lr * flags.lr_decay_rate ** sum(
                count >= b for b in bounds)
    else:
        steps = max((flags.max_epoch - warmup_epochs) * steps_per_epoch, 1)
        alpha = 1e-6 / base_lr

        def after(count):
            cosine = 0.5 * (1 + math.cos(math.pi * min(count, steps)
                                         / steps))
            return base_lr * ((1 - alpha) * cosine + alpha)

    if warmup <= 0:
        return after
    init = base_lr / flags.warmup_multiplier

    def schedule(count):
        if count < warmup:
            return init + (base_lr - init) * count / warmup
        return after(count - warmup)

    return schedule


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def clip_by_global_norm(params: tp.Iterable[torch.Tensor],
                        max_norm: float):
    """optax.clip_by_global_norm on the gradients, in place: when the
    global norm g reaches max_norm, every gradient is scaled by
    max_norm / g (no epsilon, unlike clip_grad_norm_). A few fused
    launches for all the tensors, whatever their number (GroupFree3D
    has 416)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    # stays on the device: no host sync
    scale = torch.where(norm >= max_norm, max_norm / norm, 1.0)
    torch._foreach_mul_(grads, scale)


def make_optimizer(params, kind: str = "adam", weight_decay: float = 0.0,
                   grad_clip: float | None = None, lr0: float = 1e-3):
    """Adam, or AdamW when `kind` is "adamw" or `weight_decay` is set,
    with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) and decoupled
    weight decay. With `grad_clip`, gradients are clipped to that global
    norm before each step. The learning rate is changed between steps
    with :func:`set_learning_rate`."""
    if kind not in ("adam", "adamw"):
        raise ValueError(kind)
    params = list(params)
    kw = dict(lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    if kind == "adamw" or weight_decay:
        opt = torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    else:
        opt = torch.optim.Adam(params, **kw)
    if grad_clip is not None:
        opt.register_step_pre_hook(
            lambda *_: clip_by_global_norm(params, grad_clip))
    return opt


def make_gf_optimizer(model: torch.nn.Module, lr_fn, decoder_lr_fn,
                      weight_decay: float = 5e-4, grad_clip: float = 0.1):
    """GroupFree3D's optimizer (`train_GF_FSB.py:234-244`; the JAX
    package's ``make_gf_optimizer``): the gradients clipped to a global
    norm of `grad_clip` over all parameters, then AdamW with optax's
    defaults and `weight_decay` on every parameter, in two groups:
    parameters whose top-level module name starts with ``decoder`` take
    `decoder_lr_fn`, the rest `lr_fn`. Each schedule maps the group's
    count of updates to its learning rate, set before every step, as an
    optax schedule reads its count; the counts (group key ``count``)
    travel in the optimizer's state_dict."""
    groups = {"main": [], "decoder": []}
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        groups["decoder" if top.startswith("decoder") else "main"].append(p)
    schedules = {"main": lr_fn, "decoder": decoder_lr_fn}
    opt = torch.optim.AdamW(
        [dict(params=ps, name=n, count=0) for n, ps in groups.items() if ps],
        lr=lr_fn(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    params = groups["main"] + groups["decoder"]

    def before(*_):
        clip_by_global_norm(params, grad_clip)
        for group in opt.param_groups:
            group["lr"] = schedules[group["name"]](group["count"])

    def after(*_):
        for group in opt.param_groups:
            group["count"] += 1

    opt.register_step_pre_hook(before)
    opt.register_step_post_hook(after)
    return opt


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    """Set the learning rate of every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def save_checkpoint(path, model: torch.nn.Module | dict,
                    optimizer: torch.optim.Optimizer | dict, epoch: int,
                    tmp_suffix: str = ".tmp"):
    """``torch.save({"epoch", "model", "optimizer"})`` on rank 0 only (every
    rank holds the same state), written to a temporary file (`tmp_suffix`
    in place of the path's) and renamed into place, so a reader never sees
    half a checkpoint. `model` and `optimizer` may be their
    state_dicts."""
    if parallel.rank() != 0:
        return
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"epoch": epoch,
               "model": model if isinstance(model, dict)
               else model.state_dict(),
               "optimizer": optimizer if isinstance(optimizer, dict)
               else optimizer.state_dict()}
    tmp = path.with_suffix(tmp_suffix)
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _host_copy(obj, spare=None):
    """A copy of `obj` (a state_dict: nested dicts and lists of tensors
    and plain values) whose tensors lie on the host, the copies from a
    card started without blocking into pinned memory (the caller
    synchronizes once). `spare`, an earlier copy of the same structure,
    lends its tensors where shape and dtype match."""
    if torch.is_tensor(obj):
        if not (torch.is_tensor(spare) and spare.shape == obj.shape
                and spare.dtype == obj.dtype):
            spare = torch.empty(obj.shape, dtype=obj.dtype,
                                pin_memory=obj.is_cuda)
        return spare.copy_(obj.detach(), non_blocking=True)
    if isinstance(obj, dict):
        spare = spare if isinstance(spare, dict) else {}
        return {k: _host_copy(v, spare.get(k)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        spare = spare if isinstance(spare, (list, tuple)) and len(
            spare) == len(obj) else [None] * len(obj)
        return type(obj)(_host_copy(v, s) for v, s in zip(obj, spare))
    return obj


class PreemptionGuard:
    """Save-on-SIGTERM for preemptible workers (the JAX package's
    ``PreemptionGuard``). :meth:`update` takes a host copy of the model's
    and the optimizer's state: a state_dict holds the live tensors, which
    the next ``optimizer.step()`` changes in place, so a guard that kept
    references would save a later state than its snapshot. On SIGTERM
    the newest snapshot is written with :func:`save_checkpoint` (rank 0
    only) and the process exits with 143; ``--resume`` continues from it.
    Two host copies are kept, the older one's memory reused by the next
    snapshot, so a SIGTERM during an update finds a whole snapshot.
    :meth:`close` puts the previous SIGTERM handler back."""

    def __init__(self, ckpt_path, logger=None):
        self.ckpt_path = ckpt_path
        self.logger = logger
        self.state = None
        self.epoch = -1
        self._spare = None
        self._previous = signal.signal(signal.SIGTERM, self._handler)

    def update(self, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer, epoch: int):
        state = _host_copy({"model": model.state_dict(),
                            "optimizer": optimizer.state_dict()},
                           self._spare)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._spare, self.state, self.epoch = self.state, state, epoch

    def close(self):
        signal.signal(signal.SIGTERM, self._previous)

    def _handler(self, signum, frame):
        # a second SIGTERM must not cut the save short
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        if self.state is not None:
            if self.logger:
                self.logger.info("SIGTERM: saving checkpoint at epoch %d",
                                 self.epoch)
            # a temporary file of its own: the signal may have come in the
            # middle of the loop's save of the same path
            save_checkpoint(self.ckpt_path, self.state["model"],
                            self.state["optimizer"], self.epoch,
                            tmp_suffix=".sigterm.tmp")
        raise SystemExit(143)


# tensor names only the reference implementation's modules carry
# (`pt_utils.SharedMLP`'s layers, PointNet++'s `mlp_module`)
_REFERENCE_NAME = re.compile(r"(^|\.)mlp_module\.|\.layer\d+\.conv\.weight$")


def _refuse_reference(path, state):
    """Exit with the way to convert it if `state`, a loaded torch
    checkpoint, is one the reference implementation wrote: a VoteNet
    trainer's ``{"model_state_dict", ...}``, or a GroupFree3D
    ``{"epoch", "model", "optimizer", "scheduler"}`` or a bare state_dict
    under the reference's tensor names."""
    if not isinstance(state, dict):
        return
    weights = state.get("model_state_dict", state.get("model", state))
    if "model_state_dict" in state or (
            isinstance(weights, dict)
            and any(_REFERENCE_NAME.search(str(k)) for k in weights)):
        raise SystemExit(
            f"{path} is a checkpoint of the reference implementation;"
            " convert it first with python -m"
            " backtoreality_tpu_torch.tools.torch_import"
            f" {path} --model {{votenet,votenet_da,votenet_da_jitter,"
            "groupfree,groupfree_da}} --out OUT, then pass OUT (and"
            " --query_mode exact)")


def load_checkpoint(path) -> dict:
    """The dict written by :func:`save_checkpoint` (or a ``torch.save`` of
    a state_dict), on the CPU. A checkpoint of the reference
    implementation is refused, with the command that converts it."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    _refuse_reference(path, state)
    return state


def load_weights(path) -> tuple[dict, int | None]:
    """(state_dict, epoch) from any of the three checkpoint kinds, told
    apart by their leading bytes: a JAX package checkpoint (msgpack,
    gzipped or not; through `bridge`), a ``torch.save`` of a state_dict
    (epoch None), or a training checkpoint of :func:`save_checkpoint`. A
    checkpoint of the reference implementation is refused, with the
    command that converts it."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head != b"PK":  # torch.save writes a zip archive
        variables, epoch = bridge.read_jax_checkpoint(path)
        return bridge.state_dict_from_jax(variables), epoch
    state = load_checkpoint(path)
    if "model" in state and "optimizer" in state:
        return state["model"], state["epoch"]
    return state, None


def partial_restore(model: torch.nn.Module, source: dict, log=None) -> int:
    """The `strict=False` analog (``backtoreality_tpu/train/common.py::
    partial_restore``): every entry of `model`'s state_dict whose name is
    in the state_dict `source` with the same shape takes the source's
    value, the rest keep theirs (new heads keep their fresh init). Logs
    the counts of the parameters, then of the running statistics, as the
    JAX package does: it restores ``params`` and ``batch_stats`` in two
    calls. Returns the number of entries kept fresh."""
    state = model.state_dict()
    params = {name for name, _ in model.named_parameters()}
    fresh = 0
    for group in ([k for k in state if k in params],
                  [k for k in state if k not in params]):
        copied = [k for k in group if k in source
                  and tuple(source[k].shape) == tuple(state[k].shape)]
        for k in copied:
            state[k] = source[k]
        fresh += len(group) - len(copied)
        if log:
            log(f"partial restore: copied {len(copied)} leaves, kept"
                f" {len(group) - len(copied)} fresh")
    model.load_state_dict(state)
    return fresh


def restore_weights(model: torch.nn.Module, path, what: str,
                    log=None) -> int | None:
    """Every entry of `model`'s state_dict from the checkpoint at `path`
    (any kind :func:`load_weights` reads); returns the checkpoint's epoch.
    A checkpoint that would leave an entry at its fresh init is refused
    (exit with a message naming `what`, the graph asked for): its model
    was another graph, and its weights would be trained or scored as if
    they were this one's."""
    state, epoch = load_weights(path)
    if partial_restore(model, state, log=log):
        raise SystemExit(f"{path} does not cover the {what} model: it was"
                         " trained with another graph")
    if log:
        log(f"loaded checkpoint {path}"
            + ("" if epoch is None else f" from epoch {epoch}"))
    return epoch


# ---------------------------------------------------------------------------
# Logging / metrics
# ---------------------------------------------------------------------------


def setup_logger(log_dir, name="btr", rank: int | None = None):
    """Rank-aware file + stdout logger (`utils/logger.py:30-95` analog):
    rank 0 (by default this process's) logs to stdout and
    ``log_train.txt``, rank r > 0 to ``log_train.txt.rank{r}`` only."""
    if rank is None:
        rank = parallel.rank()
    logger = logging.getLogger(f"{name}.torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s] %(message)s", datefmt="%H:%M:%S")
    if rank == 0:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_dir is not None:
        pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
        suffix = "" if rank == 0 else f".rank{rank}"
        fh = logging.FileHandler(os.path.join(log_dir,
                                              f"log_train.txt{suffix}"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def scalars(aux: dict) -> dict:
    """The 0-d entries of a criterion's aux dict, detached (they stay on
    the device)."""
    return {k: v.detach() for k, v in aux.items() if v.dim() == 0}


def update(model, optimizer, bn_momentum, forward_loss) -> dict:
    """One training update: `forward_loss()` -> (loss, aux) runs in train
    mode (dropout on, BN running statistics moving with `bn_momentum`),
    then one backward, the gradients summed over the ranks (each holds
    the part that flows through its rows of the global loss) and one
    optimizer step. Returns the aux scalars (on the device). Spans
    (`observability.span`): ``step`` around it all, ``step.backward``,
    ``step.optimizer``."""
    with span("step"):
        model.train()
        set_bn_momentum(model, bn_momentum)
        loss, aux = forward_loss()
        with span("step.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            parallel.all_reduce_grads(model.parameters())
        with span("step.optimizer"):
            optimizer.step()
        return scalars(aux)


def make_recal_step(model, *, jitter=False, before=None):
    """step(batch, bn_momentum): one train-mode forward under no_grad
    that moves only the BN running statistics (BN recalibration, the JAX
    package's ``make_recal_step``). With `jitter`, the model also takes
    the batch's centre and class labels; `before`, when given, is called
    ahead of each forward (GroupFree3D seeds its dropout there)."""

    def step(batch, bn_momentum):
        model.train()
        set_bn_momentum(model, bn_momentum)
        if before is not None:
            before()
        with torch.no_grad():
            model(*model_args(batch, jitter))

    return step


def recalibrate_bn(loader, recal_step, device, num_batches: int,
                   momentum: float = 0.2) -> int:
    """Refresh the BN running statistics with `num_batches` train-mode
    forwards over `loader` (from its start again while more are needed) at
    `momentum`, as the JAX package's ``recalibrate_bn``. Returns the
    batches run."""
    done = 0
    while done < num_batches:
        for batch in loader:
            recal_step(to_device(batch, device), momentum)
            done += 1
            if done >= num_batches:
                break
    return done


@contextlib.contextmanager
def buffers_kept(model: torch.nn.Module):
    """On exit, every buffer of `model` (the BN running statistics) holds
    its value from the entry again: an evaluation after a recalibration
    leaves the training model's statistics as they were, as the JAX loop
    recalibrates a copy of its state (``eval_state``)."""
    saved = [b.detach().clone() for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)


def fetch_aux_means(aux_hist) -> dict[str, float]:
    """Epoch means of per-step scalar aux dicts, with one device-to-host
    copy: the scalars are stacked on the device first."""
    if not aux_hist:
        return {}
    keys = [k for k, v in aux_hist[0].items() if v.dim() == 0]
    flat = torch.stack([a[k].detach().double() for a in aux_hist
                        for k in keys])
    means = flat.reshape(len(aux_hist), len(keys)).mean(0).cpu().numpy()
    return dict(zip(keys, means.astype(float)))


class MetricMeter:
    """Running means of scalar stats (the reference accumulates every
    end_points key containing loss/acc/ratio,
    `train_Votenet_FSB.py:233-243`)."""

    def __init__(self):
        self.sums = {}
        self.count = 0

    def update(self, scalars: dict):
        for key, v in scalars.items():
            v = np.asarray(v)
            if v.ndim == 0:
                self.sums[key] = self.sums.get(key, 0.0) + float(v)
        self.count += 1

    def means(self):
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}


def dump_config(log_dir, flags: dict):
    """``config.json`` in `log_dir`, from rank 0."""
    if log_dir and parallel.rank() == 0:
        path = pathlib.Path(log_dir) / "config.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(flags, indent=2, default=str))
