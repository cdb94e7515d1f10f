"""CUDA kernels a step (trace)."""

from portbench import readers


def read(out):
    return readers.launches(out, "train")
