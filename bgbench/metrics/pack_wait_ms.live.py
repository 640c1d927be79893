"""Host time one pack spends blocked on the card: the mean, over the
program's ``packer.pack`` spans in the traced window, of their summed
``wait.*`` spans (``MultiStreamPacker.pack_guarded``'s blocking copies)."""
from harness.program import wait_ms


def read(run):
    return wait_ms(run, "packer.pack")
