"""Anything built or rebuilt in the traced window: the program's ``build``
counts (a kernel library compiled or loaded, a plan executable or plan
variant built on a cache miss)."""
from harness.program import builds


def read(run):
    return builds(run)
