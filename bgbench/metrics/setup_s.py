"""From the start of the benchmark's process to the first timed dispatch
(host clock): imports, the CUDA context, the frame pool, the plan, the
kernels' build or load, and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
