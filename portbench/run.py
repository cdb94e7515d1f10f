"""The benchmark's command: one run of one cell of BENCHMARK.json.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Run from the root of a checkout, on a machine with the cell's CUDA cards;
exits nonzero, printing no result, without them.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# build and kernel caches at fixed places inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
