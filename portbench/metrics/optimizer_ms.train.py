"""Device ms a step of kernels launched inside Optimizer.step, the clip
hook included (trace)."""

from portbench import readers


def read(out):
    return readers.phase_ms(out, "optimizer")
