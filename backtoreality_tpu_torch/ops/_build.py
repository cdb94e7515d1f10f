"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. On first
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/`` at the repository root and loaded with ``ctypes``.
The library's file name carries a hash of its source, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs
at import time: the CPU tests import every module of the port on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA"
                       " toolkit (PATH or /usr/local/cuda/bin)")


class Kernel:
    """One CUDA source built into one shared library.

    ``signatures`` maps each exported C function to its ctypes argument
    types (every function returns an int, a ``cudaError_t``).
    ``launches`` counts the kernel launches made through the op's
    wrapper; the wrapper adds one per launch and nothing else does.
    ``backward_launches`` counts the same for the op's backward, where
    the source has one. ``bytes`` sums the input and output bytes of those
    launches (forward and backward), each tensor counted once, as XLA
    counts a custom call's operands: the dispatcher never sees a ctypes
    launch, so a byte count of aten ops (``tools/mfu.py``) reads it here.
    """

    def __init__(self, name: str, source: str, replaces: str,
                 signatures: dict[str, list]):
        self.name = name
        self.source = CSRC / source
        self.replaces = replaces
        self.signatures = signatures
        self.launches = 0
        self.backward_launches = 0
        self.bytes = 0
        self._lib = None

    def library_path(self) -> pathlib.Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def start_build(self):
        """Start ``nvcc`` unless the library is built. Returns the running
        process and its output file, or None if there is nothing to do."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started) -> str:
        """Wait for a build from `start_build`; returns nvcc's output."""
        if started is None:
            return ""
        proc, tmp = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name} ({proc.returncode}):"
                f"\n{log}")
        # rename into place: a concurrent build never sees half a file
        os.replace(tmp, self.library_path())
        return log

    @property
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib


class Entry:
    """A further entry into a kernel's library (another C function in the
    same source), with launch and byte counts of its own: ``bytes`` where
    its device code is its own, else the kernel's."""

    def __init__(self, kernel: Kernel, name: str,
                 replaces: str | None = None):
        self.kernel = kernel
        self.name = name
        self.replaces = kernel.replaces if replaces is None else replaces
        self.launches = 0
        self.backward_launches = 0
        self.bytes = 0


def build_all(kernels) -> dict[str, str]:
    """Build every kernel in parallel (one nvcc each, all started
    together); returns nvcc's output by kernel name ('' if cached)."""
    started = {k.name: k.start_build() for k in kernels}
    logs = {}
    for k in kernels:
        logs[k.name] = k.finish_build(started[k.name])
        k.lib  # load now, so a bad library fails here
    return logs


def nbytes(*tensors) -> int:
    """The bytes of `tensors` (None skipped): what a launch reads or
    writes of them."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
