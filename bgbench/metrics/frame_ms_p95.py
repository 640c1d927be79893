"""The 95th percentile (nearest rank), over every frame of the window, of
the time from the frame's due time to its pack's completion (host clock).
Only an open loop gives frames a due time."""
from harness.stats import percentile


def read(run):
    return percentile(run.latencies_ms, 95) if run.latencies_ms else None
