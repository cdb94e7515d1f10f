"""Data parallelism over processes: the process group, the row split and
the collectives of a global-batch train step.

Counterpart of ``backtoreality_tpu/parallel/mesh.py``. The JAX package
jits its train step over a mesh with the batch sharded, so XLA computes
the BN moments and every criterion's reductions over the global batch and
sums the gradients. The port runs one process a device (a rank) and does
the same by hand:

* BatchNorm all-reduces its batch moments (:func:`all_reduce_sum`, whose
  backward all-reduces the gradient);
* the train steps gather the criterion's inputs in rank order
  (:func:`gather_rows`, whose backward keeps this rank's rows), so every
  rank computes the same global loss;
* :func:`all_reduce_grads` then sums the parameter gradients: each rank's
  holds the part of the gradient that flows through its own rows.

Only ``all_reduce`` and ``broadcast`` are used: gloo has no other
collective on CUDA tensors, and two ranks sharing one card talk over
gloo. A gather is an all-reduce of a zero-padded buffer (adding zeros is
exact). Without a process group, or in a group of one, every function
here returns its input and communicates nothing.

The JAX module's ``local_rows``/``local_rows_tree`` move a sharded array
to the host; here a rank's rows are a tensor on its device, and their
counterpart is ``.cpu()``.
"""

from __future__ import annotations

import datetime
import math
import re
import socket

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises: a rank that died
# must not leave the others waiting forever
TIMEOUT = datetime.timedelta(minutes=10)

# end_points no criterion reads: the per-point features and the input
# cloud, the largest entries by far. They are left out of the gather, so
# a criterion that read one would raise KeyError, never see local rows.
_UNREAD = re.compile(r"(_features?|^point_clouds)$")


def world() -> int:
    """The number of ranks: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank: 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_shard_info() -> tuple[int, int]:
    """(num_shards, shard_index) for a rank's own loader shard
    (``--multihost``)."""
    return world(), rank()


def backend(device: torch.device, local_ranks: int) -> str:
    """NCCL when every local rank has a card of its own, else gloo (on
    the CPU, and when local ranks share a card: NCCL refuses two ranks on
    one device)."""
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(rank_: int, world_: int, address: str, device: torch.device,
         local_ranks: int) -> str:
    """Join the process group at ``tcp://address`` (host:port) as rank
    `rank_` of `world_`, over the backend :func:`backend` picks; returns
    its name."""
    name = backend(device, local_ranks)
    dist.init_process_group(name, init_method=f"tcp://{address}",
                            world_size=world_, rank=rank_, timeout=TIMEOUT)
    return name


def shutdown():
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def replicate(module: torch.nn.Module):
    """Every parameter and buffer of `module` takes rank 0's value, in
    place (the JAX ``replicate``: every rank starts from one state)."""
    if world() == 1:
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)


def check_same(value: int, what: str):
    """Raise unless every rank passes the same `value`: ranks whose loops
    ran different numbers of collectives would wait on each other."""
    if world() == 1:
        return
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    both = torch.tensor([value, -value], device=device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if both[0].item() != -both[1].item():
        raise RuntimeError(f"the ranks disagree on the {what}: from"
                           f" {-both[1].item()} to {both[0].item()}")


def shard_rows(batch: dict, even: bool = True) -> tuple[dict, tuple]:
    """``--num_devices``: this rank's rows of a host batch that every
    rank holds whole, and the rows of every rank. Rank r keeps rows
    ``[r·B/W, (r+1)·B/W)``; with `even` (training), B must divide by W.
    An evaluation batch may not: the first ranks take one row more, a
    rank left without rows runs the first row, and its sizes entry, 0,
    keeps it out of every gather."""
    rows = len(next(iter(batch.values())))
    w, r = world(), rank()
    if even and rows % w:
        raise ValueError(f"a batch of {rows} rows does not split over {w}"
                         " ranks: --batch_size must divide by"
                         " --num_devices")
    sizes = tuple(len(a) for a in np.array_split(np.arange(rows), w))
    start = sum(sizes[:r])
    take = slice(start, start + sizes[r]) if sizes[r] else slice(0, 1)
    return {k: v[take] for k, v in batch.items()}, sizes


class ShardedRows:
    """``--num_devices``: `loader`'s batches, each cut to this rank's rows
    (:func:`shard_rows`); iterable again and again, as the loader."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield shard_rows(batch)[0]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks; the gradient of each rank's `x` is
    the sum of the ranks' gradients of the result."""
    if world() == 1:
        return x
    return _AllReduceSum.apply(x)


def _gather_packed(xs, sizes, r):
    """All of `xs` (one dtype, rows first) gathered by one all-reduce of
    one zero-padded buffer; rank r's first sizes[r] rows go to rows
    [sum(sizes[:r]), sum(sizes[:r+1])) of each result."""
    total, off, n = sum(sizes), sum(sizes[:r]), sizes[r]
    widths = [math.prod(x.shape[1:]) for x in xs]
    buf = xs[0].new_zeros(total * sum(widths))
    pos = 0
    for x, width in zip(xs, widths):
        buf[pos + off * width:pos + (off + n) * width] = x[:n].reshape(-1)
        pos += total * width
    dist.all_reduce(buf)
    out, pos = [], 0
    for x, width in zip(xs, widths):
        out.append(buf[pos:pos + total * width].view(total, *x.shape[1:])
                   .clone())
        pos += total * width
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sizes, r, *xs):
        ctx.sizes, ctx.r = sizes, r
        ctx.shapes = [x.shape for x in xs]
        return tuple(_gather_packed(xs, sizes, r))

    @staticmethod
    def backward(ctx, *grads):
        off, n = sum(ctx.sizes[:ctx.r]), ctx.sizes[ctx.r]
        out = []
        for g, shape in zip(grads, ctx.shapes):
            if g is None:
                out.append(None)
            elif shape[0] == n:
                out.append(g[off:off + n])
            else:  # a rank without rows ran one: it takes no gradient
                local = g.new_zeros(shape)
                local[:n] = g[off:off + n]
                out.append(local)
        return (None, None, *out)


def gather_rows(tree: dict, sizes: tuple | None = None) -> dict:
    """The global batch of `tree` (a dict of tensors, rows first): every
    entry the criteria read, gathered from every rank in rank order, with
    the gradient flowing back to this rank's rows. `sizes` are the rows
    of each rank (default: this rank's, on every rank). The features and
    the input cloud are left out (no criterion reads them); entries that
    are not tensors of rows stay as they are. One all-reduce a dtype."""
    if world() == 1:
        return tree
    rows = len(tree["point_clouds"])
    sizes = tuple(sizes or (rows,) * world())
    out = {k: v for k, v in tree.items() if not _UNREAD.search(k)}
    keys = [k for k, v in out.items() if torch.is_tensor(v) and v.dim()]
    for k in keys:
        if len(out[k]) != rows:
            raise ValueError(f"{k}: {len(out[k])} rows, the batch has"
                             f" {rows}")
    by_dtype = {}
    for k in keys:
        by_dtype.setdefault(out[k].dtype, []).append(k)
    for dtype, group in by_dtype.items():
        xs = [out[k] for k in group]
        if dtype.is_floating_point:
            ys = _GatherRows.apply(sizes, rank(), *xs)
        else:
            with torch.no_grad():
                wide = torch.uint8 if dtype == torch.bool else dtype
                ys = [y.to(dtype) for y in _gather_packed(
                    [x.to(wide) for x in xs], sizes, rank())]
        out.update(zip(group, ys))
    return out


def all_reduce_grads(params) -> None:
    """Sum every parameter's gradient over the ranks, one all-reduce a
    dtype. A parameter that has no gradient on any rank keeps none (Adam
    then leaves it alone, as on one device); one that has a gradient on
    some rank gets the sum, the others counting zero."""
    if world() == 1:
        return
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for dtype, group in by_dtype.items():
        has = torch.tensor([p.grad is not None for p in group], dtype=dtype,
                           device=group[0].device)
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in group] + [has])
        dist.all_reduce(flat)
        pos = 0
        for p, any_grad in zip(group, flat[-len(group):].tolist()):
            seg = flat[pos:pos + p.numel()].view_as(p)
            pos += p.numel()
            p.grad = seg if any_grad else None
