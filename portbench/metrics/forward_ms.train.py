"""Device ms a step of kernels launched from the units' thread outside the
optimizer's step: forward and loss (trace)."""

from portbench import readers


def read(out):
    return readers.phase_ms(out, "forward")
