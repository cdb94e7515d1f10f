"""The share of the traced requests with nothing running on the device
(trace)."""

from portbench import readers


def read(out):
    return readers.idle_pct(out, "serve")
