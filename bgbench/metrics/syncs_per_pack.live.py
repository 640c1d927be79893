"""Points where the host blocked on the card, per pack: the program's
``sync`` counts under its ``packer.pack`` spans in the traced window, over
the packs."""
from harness.program import syncs_per_root


def read(run):
    return syncs_per_root(run, "packer.pack")
