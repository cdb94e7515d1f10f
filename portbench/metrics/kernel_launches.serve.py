"""CUDA kernels a request (trace)."""

from portbench import readers


def read(out):
    return readers.launches(out, "serve")
