"""Host time one pack spends working: the mean, over the program's
``packer.pack`` spans in the traced window, of each span less its
``wait.*`` spans."""
from harness.program import work_ms


def read(run):
    return work_ms(run, "packer.pack")
