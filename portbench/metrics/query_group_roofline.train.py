"""The ball queries' and groupings' least time a step, forward and backward
(portbench/work.py), over those kernels' device time (trace)."""

from portbench import readers


def read(out):
    return readers.roofline(out, "train",
                            ("query", "group", "group_backward"),
                            readers.QUERY_KERNELS, readers.GROUP_KERNELS)
