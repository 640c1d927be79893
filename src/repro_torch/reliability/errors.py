"""Structured errors of the serving layer: the port's copy of the part of
``repro/reliability/errors.py`` that the async engine and the guards raise.

Every failure a client can observe through a
:class:`~concurrent.futures.Future` resolves to one of these types (or a
plain caller error like ``KeyError`` for a never-opened stream), so a
service front can branch on the kind of failure. Each exception carries its
context as attributes; the message is rendered from them.
:class:`AdmissionError` is a ``ValueError`` (a rejected submit is the
caller's problem); the rest derive from ``RuntimeError``.
"""
from __future__ import annotations

from typing import Hashable

__all__ = [
    "ReliabilityError",
    "AdmissionError",
    "EngineTimeout",
    "DeadlineExceeded",
    "NonFiniteOutput",
    "EngineClosed",
]


class ReliabilityError(RuntimeError):
    """Base class for structured serving failures."""


class AdmissionError(ValueError):
    """A frame was rejected at submit time (shape / dtype / non-finite)."""

    def __init__(self, reason: str, *, stream_id: Hashable = None):
        self.reason = reason
        self.stream_id = stream_id
        sid = "" if stream_id is None else f" (stream {stream_id!r})"
        super().__init__(f"frame rejected at admission{sid}: {reason}")


class EngineTimeout(ReliabilityError):
    """An in-flight batch did not complete within ``timeout_s``."""

    def __init__(self, timeout_s: float, *, uids=()):
        self.timeout_s = timeout_s
        self.uids = tuple(uids)
        super().__init__(
            f"in-flight batch exceeded the {timeout_s * 1e3:.0f}ms engine "
            f"watchdog (uids {list(self.uids)})"
        )


class DeadlineExceeded(ReliabilityError):
    """The request's latency deadline passed before dispatch; it was shed
    at collect time instead of being served at full cost past its SLA."""

    def __init__(self, uid: int, late_s: float):
        self.uid = uid
        self.late_s = late_s
        super().__init__(
            f"request {uid} shed: deadline passed {late_s * 1e3:.1f}ms "
            f"before dispatch"
        )


class NonFiniteOutput(ReliabilityError):
    """The post-dispatch finite-guard caught NaN/Inf in this request's
    output frame; the frame is withheld."""

    def __init__(self, uid: int, *, stream_id: Hashable = None):
        self.uid = uid
        self.stream_id = stream_id
        sid = "" if stream_id is None else f" (stream {stream_id!r})"
        super().__init__(
            f"request {uid}{sid}: output frame contains non-finite values"
        )


class EngineClosed(ReliabilityError):
    """The engine shut down before this request could be dispatched."""
