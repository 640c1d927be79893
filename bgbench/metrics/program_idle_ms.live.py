"""Device idle time inside one pack: the mean, over the program's
``packer.pack`` spans in the traced window, of the time within each span in
which the device ran no op of the trace."""
from harness.program import idle_ms


def read(run):
    return idle_ms(run, "packer.pack")
