"""Shared training machinery: schedules, optimizer, checkpoints, logging.

Counterpart of the parts of ``backtoreality_tpu/train/common.py`` that
the FSB recipe uses: the reference's epoch-step learning rate and BN
momentum schedules, Adam/AdamW with optax's defaults and an optional
global-norm clip in optax's formula, atomic checkpoints of the model and
optimizer, the cross-stage partial restore (BR weights grafted into
CenterRefine, the JAX package's checkpoints into the port), a metric
meter and the train logger. Single process; the multi-host rendezvous
and the preemption guard are not ported.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import pathlib
import sys
import typing as tp

import numpy as np
import torch

from backtoreality_tpu_torch import bridge
from backtoreality_tpu_torch.nn.norm import bn_momentum_schedule

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


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def clip_by_global_norm(params: tp.Iterable[torch.Tensor],
                        max_norm: float):
    """optax.clip_by_global_norm on the gradients, in place: when the
    global norm g reaches max_norm, every gradient becomes
    grad / g * max_norm (no epsilon, unlike clip_grad_norm_)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = norm >= max_norm  # stays on the device: no host sync
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


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


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    """Set the learning rate of every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def save_checkpoint(path, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, epoch: int):
    """``torch.save({"epoch", "model", "optimizer"})``, written to a
    temporary file and renamed into place, so a reader never sees half a
    checkpoint."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"epoch": epoch, "model": model.state_dict(),
               "optimizer": optimizer.state_dict()}
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path) -> dict:
    """The dict written by :func:`save_checkpoint`, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_weights(path) -> tuple[dict, int | None]:
    """(state_dict, epoch) from any of the three checkpoint kinds, told
    apart by their leading bytes: a JAX package checkpoint (msgpack,
    gzipped or not; through `bridge`), a ``torch.save`` of a state_dict
    (epoch None), or a training checkpoint of :func:`save_checkpoint`."""
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


# ---------------------------------------------------------------------------
# Logging / metrics
# ---------------------------------------------------------------------------


def setup_logger(log_dir, name="btr"):
    """File + stdout logger (`utils/logger.py:30-95` analog)."""
    logger = logging.getLogger(f"{name}.torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s] %(message)s", datefmt="%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir is not None:
        pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "log_train.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


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
    if log_dir:
        path = pathlib.Path(log_dir) / "config.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(flags, indent=2, default=str))
