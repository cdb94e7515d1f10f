"""FPS's least time a step (portbench/work.py, the step's calls) over the
FPS kernels' device time (trace)."""

from portbench import readers


def read(out):
    return readers.roofline(out, "train", ("fps",), readers.FPS_KERNELS)
