"""What the per-layer metric readers share. Each reader is one file in
``metrics/`` that calls one of these with the span that marks one dispatch
of its cells' entry point (``engine`` in the closed loop, ``pack`` in the
open one); each returns ``None`` where the run has nothing to read."""
from __future__ import annotations

from typing import Optional

from .counts import frame_bound_s

__all__ = ["mean_span_ms", "ops_per_span", "roofline_share", "idle_share"]


def mean_span_ms(run, span: str) -> Optional[float]:
    """The mean host ms of the span over the window."""
    spans = run.spans.get(span)
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)


def ops_per_span(run, span: str) -> Optional[float]:
    """Device operations (kernels, copies, memsets) of the traced window per
    dispatch marked by the span."""
    spans = run.spans.get(span)
    if run.trace is None or not spans or not run.trace.ops:
        return None
    return len(run.trace.ops) / len(spans)


def roofline_share(run, span: str, ops: Optional[str] = None) -> Optional[float]:
    """The counted bound of one frame's step (``harness/counts.py``: the
    temporal step, carry read and written, where the run's entry point
    carries one) over the device time per frame completed in the traced
    window, in %. That time is the device's busy time (every kernel, copy
    and memset) or, with ``ops``, the summed time of the ops whose name
    holds it."""
    if run.trace is None or span not in run.spans or run.completed == 0:
        return None
    seconds = run.trace.busy_s if ops is None else run.trace.op_seconds(ops)
    if seconds <= 0:
        return None
    return 100.0 * frame_bound_s(run.config, temporal=run.temporal) / (seconds / run.completed)


def idle_share(run, span: str) -> Optional[float]:
    """1 minus the union of the device's op intervals over the traced
    window, in %."""
    if run.trace is None or span not in run.spans or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
