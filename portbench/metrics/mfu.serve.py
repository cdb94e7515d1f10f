"""A forward's model FLOPs (FlopCounterMode) times the window's requests,
over the window's wall, as a share of the card's f32 peak."""

from portbench import readers


def read(out):
    return readers.mfu(out, "serve")
