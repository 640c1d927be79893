"""Device idle time inside one frame-engine dispatch: the mean, over the
program's ``engine.step`` spans in the traced window, of the time within
each span in which the device ran no op of the trace."""
from harness.program import idle_ms


def read(run):
    return idle_ms(run, "engine.step")
