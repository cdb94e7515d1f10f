"""Seconds from the process's start to the first measured step or request
(host clock)."""


def read(out):
    return out.setup_s
