"""Scenes every step of the window trained, over the window's wall (host
clock, closed by a synchronise)."""

from portbench import readers


def read(out):
    return readers.rate(out, "train")
