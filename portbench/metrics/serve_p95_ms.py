"""The 95th percentile of the latencies of all the window's requests (host
clock)."""

from portbench import readers


def read(out):
    return readers.p95_ms(out)
