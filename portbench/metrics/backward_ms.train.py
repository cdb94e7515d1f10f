"""Device ms a step of kernels launched from the autograd engine's thread
(trace)."""

from portbench import readers


def read(out):
    return readers.phase_ms(out, "backward")
