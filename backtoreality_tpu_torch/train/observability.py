"""Training observability: the scalar history.

Counterpart of ``ScalarHistory`` in
``backtoreality_tpu/train/observability.py``: an append-only JSONL of
per-epoch scalar means, plottable and machine-readable. The JAX
package's step timer and profiler hook are not ported.
"""

from __future__ import annotations

import json
import pathlib


class ScalarHistory:
    """Append scalar dicts to `<log_dir>/metrics.jsonl`."""

    def __init__(self, log_dir, name: str = "metrics"):
        self.path = None
        if log_dir is not None:
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
