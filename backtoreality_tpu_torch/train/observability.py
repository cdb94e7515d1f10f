"""Training observability: scalar history, step timing, profiler hooks.

Counterpart of ``backtoreality_tpu/train/observability.py``:

* :class:`ScalarHistory` — append-only JSONL of per-epoch scalar means
  (plottable, machine-readable, rank 0 only);
* :class:`StepTimer` — wall-clock step/epoch timing with scenes/s;
* :func:`profile` — a ``torch.profiler`` trace of CPU and CUDA activity
  (``--profile_dir``), exported as a Chrome trace, the counterpart of the
  JAX package's ``jax.profiler`` context; :class:`TraceWindow` traces
  host steps 10-15 of a run, as the JAX trainers do;
* :func:`span` / :func:`spanned` — a named range at a layer boundary of
  the port (the train step, the models and their layers, the criteria,
  the hand kernels' launches), recorded only while a profiler records:
  in ``--profile_dir``'s trace, and in any ``torch.profiler`` session, on
  the clock of its CUDA kernel records. The names are those of PERF.md
  §3.
"""

from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import time

import torch

from backtoreality_tpu_torch import parallel


_recording = torch._C._autograd._profiler_enabled
# torch.profiler.record_function's range (RecordScope.USER_SCOPE, a
# ``user_annotation`` event) without its trip through the dispatcher: 4.4
# against 12.0 us a range while a profiler records (an H100 machine's host)
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit
_NO_SPAN = contextlib.nullcontext()


class _Range:
    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = _range_enter(self.name)

    def __exit__(self, *exc):
        _range_exit(self.handle)


def span(name: str):
    """A context that records the range `name` while a profiler records
    (on this thread: autograd's device threads inherit the session), and
    otherwise the one shared no-op context, which allocates nothing.
    `name` should be a constant, never built on the hot path."""
    if _recording():
        return _Range(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


class ScalarHistory:
    """Append scalar dicts to `<log_dir>/metrics.jsonl` (rank 0)."""

    def __init__(self, log_dir, name: str = "metrics"):
        self.path = None
        if log_dir is not None and parallel.rank() == 0:
            d = pathlib.Path(log_dir)
            d.mkdir(parents=True, exist_ok=True)
            self.path = d / f"{name}.jsonl"

    def append(self, step: int, scalars: dict, **extra):
        if self.path is None:
            return
        row = {"step": step, **extra}
        for key, v in scalars.items():
            try:
                row[key] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")


class StepTimer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.time()
        self.steps = 0
        self.scenes = 0

    def tick(self, batch_size: int):
        self.steps += 1
        self.scenes += batch_size

    @property
    def elapsed(self) -> float:
        return time.time() - self.t0

    @property
    def scenes_per_sec(self) -> float:
        return self.scenes / max(self.elapsed, 1e-9)


@contextlib.contextmanager
def profile(profile_dir):
    """A ``torch.profiler`` trace of the CPU and (where present) CUDA
    activity within, written on exit as
    ``<profile_dir>/trace_rank{r}.json`` (Chrome trace format); no-op when
    `profile_dir` is None."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    path = pathlib.Path(profile_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / f"trace_rank{parallel.rank()}.json"))


class TraceWindow:
    """Trace host steps `first` to `last` of a run (the JAX trainers'
    window: 10-15) into `profile_dir`; call :meth:`before` and
    :meth:`after` around each step with its 1-based count, and
    :meth:`close` at the end (a run shorter than the window writes the
    steps it had)."""

    def __init__(self, profile_dir, first: int = 10, last: int = 15):
        self.profile_dir, self.first, self.last = profile_dir, first, last
        self._stack = contextlib.ExitStack()

    def before(self, step: int):
        if self.profile_dir and step == self.first:
            self._stack.enter_context(profile(self.profile_dir))

    def after(self, step: int):
        if step == self.last:
            self.close()

    def close(self):
        self._stack.close()
