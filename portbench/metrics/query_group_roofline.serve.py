"""The ball queries' and groupings' least time a request
(portbench/work.py), over those kernels' device time (trace)."""

from portbench import readers


def read(out):
    return readers.roofline(out, "serve", ("query", "group"),
                            readers.QUERY_KERNELS, readers.GROUP_KERNELS)
