"""Structured fleet-layer errors: the port of ``repro/fleet/errors.py``.

Same philosophy as :mod:`repro_torch.reliability.errors`: every failure a
client observes through the router is typed and carries the context needed
to act on it. Operational failures (saturation, a dead worker) subclass
:class:`~repro_torch.reliability.errors.ReliabilityError` so one
``except`` guards the whole serving stack; configuration bugs (a mixed-hash fleet) are
``ValueError`` — they fail construction fast and are never retried.
"""
from __future__ import annotations

from repro_torch.reliability.errors import ReliabilityError

__all__ = [
    "FleetError",
    "FleetSaturated",
    "WorkerDown",
    "PlanMismatch",
    "CodecError",
    "ConnectionClosed",
]


class FleetError(ReliabilityError):
    """Base class for router/fleet operational failures."""


class FleetSaturated(FleetError):
    """Router-level load shed: the target worker's backlog reached the
    router's ``max_worker_queue`` bound, so the frame was refused *before*
    touching the worker's own (larger) request queue — the fleet's
    backpressure fires first, and worker queues never overflow."""

    def __init__(self, stream_id, wid, depth: int, limit: int):
        self.stream_id = stream_id
        self.wid = wid
        self.depth = depth
        self.limit = limit
        where = "stateless pool" if stream_id is None else f"stream {stream_id!r}"
        super().__init__(
            f"fleet saturated: worker {wid!r} backlog {depth} >= "
            f"{limit} ({where}); shed at the router"
        )


class WorkerDown(FleetError):
    """A worker is dead (killed, closed, or failed health checks) and the
    request could not be served — raised after the router has already
    re-pinned the worker's streams, when no live worker remains."""

    def __init__(self, wid, detail: str = ""):
        self.wid = wid
        super().__init__(
            f"worker {wid!r} is down{': ' + detail if detail else ''}"
        )


class PlanMismatch(ValueError):
    """A fleet was constructed from workers running different compiled
    dispatch recipes (``BGPlan.plan_hash`` disagreement). Temporal carries
    produced under one dispatch geometry are not interchangeable with
    another's, so a mixed fleet could corrupt streams on rebalance — refused
    at construction, like any other caller bug."""


class CodecError(FleetError):
    """A wire message failed validation: truncated, bad magic/version,
    CRC mismatch, a length field past the hard cap, or an array header
    whose geometry disagrees with its payload byte count. The transport
    treats the connection as poisoned (framing is desynchronized after any
    torn message) and resets it; the failure surfaces as a structured
    :class:`WorkerDown`, never a hang."""


class ConnectionClosed(FleetError):
    """The peer closed the socket cleanly *between* messages — the one
    close signal that is not a torn frame. Graceful child exit lands here;
    everything mid-message lands in :class:`CodecError`."""
