"""Host time of one dispatch into the frame engine: the mean, over the
window, of the benchmark's span around the ``submit()`` calls and the
``step()`` of one dispatch (``FrameDenoiseEngine``, serving/frames.py)."""
from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "engine")
