"""Training observability: scalar history, step timing, profiler hooks.

Counterpart of ``backtoreality_tpu/train/observability.py``:

* :class:`ScalarHistory` — append-only JSONL of per-epoch scalar means
  (plottable, machine-readable, rank 0 only);
* :class:`StepTimer` — wall-clock step/epoch timing with scenes/s;
* :func:`profile` — a ``torch.profiler`` trace of CPU and CUDA activity
  (``--profile_dir``), exported as a Chrome trace, the counterpart of the
  JAX package's ``jax.profiler`` context; :class:`TraceWindow` traces
  host steps 10-15 of a run, as the JAX trainers do.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time

import torch

from backtoreality_tpu_torch import parallel


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
