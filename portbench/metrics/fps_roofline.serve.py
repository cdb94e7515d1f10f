"""FPS's least time a request (portbench/work.py, the request's calls) over
the FPS kernels' device time (trace)."""

from portbench import readers


def read(out):
    return readers.roofline(out, "serve", ("fps",), readers.FPS_KERNELS)
