"""The native host library: oriented-box IoU for AP matching, in C++.

Counterpart of ``backtoreality_tpu/eval/native.py``. VOC AP matching
computes the IoU of every (detection, ground truth) pair of a class and
scene (`eval_det.eval_det_cls`); in Python that loop is the evaluation's
host-side hot spot (the reference spreads it over a process pool). The
source, ``csrc/btr_native.cpp``, is a copy of the JAX package's
``native/btr_native.cpp``.

On first use it is compiled with ``g++ -O3 -fPIC -shared -std=c++17``
(the flags of the JAX package's Makefile) into ``build/native/`` at the
repository root and loaded with ``ctypes``, as ``ops/_build.py`` builds
the CUDA kernels: the library's name carries a hash of its source, and
each build writes a file of its own and renames it into place, so a
process never loads a library that another is still writing, and an
edited source is rebuilt. Nothing is built at import time.

There is no fallback: a library that does not build or load raises, with
the compiler's output. A caller who wants the Python loop passes its own
``get_iou_func`` to ``eval_det``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "btr_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
COMPILER = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"]
_lib = None


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libbtr_native-{digest}.so"


def build() -> pathlib.Path:
    """The library's path, compiled first unless it is there. Raises
    RuntimeError with the compiler's output if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*COMPILER, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"{COMPILER[0]} could not run for"
                           f" {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{COMPILER[0]} failed for {SOURCE.name}"
                           f" ({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    # rename into place: a concurrent build never sees half a file
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.box3d_iou_matrix.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.box3d_iou_matrix.restype = None
        lib.box3d_iou_single.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.box3d_iou_single.restype = ctypes.c_double
        _lib = lib
    return _lib


def box3d_iou_matrix(corners1: np.ndarray,
                     corners2: np.ndarray) -> np.ndarray:
    """(n, 8, 3) x (m, 8, 3) corners -> (n, m) 3D IoU, float64."""
    lib = load()
    c1 = np.ascontiguousarray(corners1, dtype=np.float64)
    c2 = np.ascontiguousarray(corners2, dtype=np.float64)
    n, m = len(c1), len(c2)
    out = np.empty((n, m), dtype=np.float64)
    lib.box3d_iou_matrix(
        c1.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        c2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
