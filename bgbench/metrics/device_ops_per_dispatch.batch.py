"""Device operations (kernels, copies, memsets) per frame-engine dispatch
in the traced window, from the profiler's trace."""
from harness.readers import ops_per_span


def read(run):
    return ops_per_span(run, "engine")
