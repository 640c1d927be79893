"""Host time of one pack: the mean, over the window, of the benchmark's
span around one ``pack()`` call (``MultiStreamPacker``, video/session.py)."""
from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "pack")
