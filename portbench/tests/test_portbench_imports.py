"""What the benchmark's command loads holds no JAX: a fresh interpreter
imports ``portbench/run.py`` and every module a run of each cell loads
(the harness, the families and the system's modules they build, the
modes, the metric readers, the tracing and counting code) and no module
whose top-level name, the part before the first dot compared whole, is
``jax``, ``jaxlib``, ``flax`` or ``backtoreality_tpu`` may be among
``sys.modules``. The system's package, ``backtoreality_tpu_torch``,
begins with the JAX package's name and is not one of them. The plain
reference of ``portbench/reference/`` imports nothing of the system."""

import json
import subprocess
import sys

from portbench.harness import FORBIDDEN, ROOT

LOAD_A_RUN = """
import json, runpy, sys
sys.argv = ["run.py"]
runpy.run_path("portbench/run.py", run_name="portbench_run")
from portbench import faults, harness, readings, trace, work
for w in harness.benchmark()["workloads"]:
    ctx = harness.Context(w["name"], harness.cell(w["name"]), 1, 1.0, True,
                          None, 0.0)
    ctx.family.shapes(ctx.config)
    ctx.family.program_trainer, ctx.family.program_server
for m in harness.benchmark()["end_to_end"] + harness.benchmark()["per_layer"]:
    harness.reader(m["name"])
from backtoreality_tpu_torch.train import common, evaluate, groupfree, votenet
from backtoreality_tpu_torch.losses import groupfree, votenet
from backtoreality_tpu_torch.models.groupfree import transformer
print(json.dumps(sorted({m.split(".", 1)[0] for m in list(sys.modules)})))
"""

REFERENCE_ALONE = """
import json, sys
import portbench.reference.groupfree, portbench.reference.losses
import portbench.reference.nn, portbench.reference.ops
import portbench.reference.optim, portbench.reference.votenet
print(json.dumps(sorted({m.split(".", 1)[0] for m in list(sys.modules)})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(LOAD_A_RUN)
    assert "backtoreality_tpu_torch" in names  # the system was loaded
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_system():
    names = _top_level(REFERENCE_ALONE)
    assert "torch" in names
    assert not names & (set(FORBIDDEN) | {"backtoreality_tpu_torch"})
