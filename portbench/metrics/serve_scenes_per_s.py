"""Scenes every request of the window served, over the window's wall (host
clock)."""

from portbench import readers


def read(out):
    return readers.rate(out, "serve")
