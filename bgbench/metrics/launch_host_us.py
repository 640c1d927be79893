"""Host time of one kernel launch: the mean of the program's ``kernel.*``
spans in the traced window (a wrapper's checks, the ctypes call, the error
check and the launch counter). The window is traced, so each span also holds
the profiler's launch callback, most of what it reads."""
from harness.program import kernel_host_us


def read(run):
    return kernel_host_us(run)
