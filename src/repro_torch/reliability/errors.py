"""Structured errors of the serving layer: the port of
``repro/reliability/errors.py``, plus the two kernel errors of the port.

Every failure a client can observe through a
:class:`~concurrent.futures.Future` resolves to one of these types (or a
plain caller error like ``KeyError`` for a never-opened stream), so a
service front can branch on the kind of failure. Each exception carries its
context as attributes; the message is rendered from them.
:class:`AdmissionError` is a ``ValueError`` (a rejected submit is the
caller's problem); the rest derive from ``RuntimeError``.

The retry layer (``repro_torch.reliability.retry``) treats ``KeyError`` /
``ValueError`` / ``TypeError`` as caller bugs and fails fast, and
:class:`ReliabilityError` subclasses stay retryable. :class:`KernelBuildError`
(nvcc missing or refusing a source) and :class:`KernelLaunchError` (a CUDA
error returned by a kernel's launch) are ``RuntimeError`` subclasses that the
retry layer never retries and never serves from a lower rung: a fallback
would hide a broken kernel behind the plain reference.
"""
from __future__ import annotations

from typing import Hashable, Optional

__all__ = [
    "ReliabilityError",
    "AdmissionError",
    "InjectedFault",
    "EngineTimeout",
    "DeadlineExceeded",
    "NonFiniteOutput",
    "AllBackendsFailed",
    "EngineClosed",
    "KernelBuildError",
    "KernelLaunchError",
]


class ReliabilityError(RuntimeError):
    """Base class for structured serving failures (retryable by default)."""


class KernelBuildError(RuntimeError):
    """A kernel source could not be built: no nvcc, or nvcc refused it.
    Never retried and never answered by a lower rung."""


class KernelLaunchError(RuntimeError):
    """A kernel's launch returned a CUDA error. Never retried and never
    answered by a lower rung."""


class AdmissionError(ValueError):
    """A frame was rejected at submit time (shape / dtype / non-finite)."""

    def __init__(self, reason: str, *, stream_id: Hashable = None):
        self.reason = reason
        self.stream_id = stream_id
        sid = "" if stream_id is None else f" (stream {stream_id!r})"
        super().__init__(f"frame rejected at admission{sid}: {reason}")


class InjectedFault(ReliabilityError):
    """A deterministic fault raised by ``repro_torch.reliability.faults``:
    the test double for a transient device or dispatch error (retryable)."""

    def __init__(self, reason: str, *, dispatch: Optional[int] = None):
        self.reason = reason
        self.dispatch = dispatch
        super().__init__(reason)


class EngineTimeout(ReliabilityError):
    """The engine watchdog expired waiting for an in-flight batch: its
    futures fail with this error, the breaker of the rung that dispatched it
    records the failure, and the engine keeps serving."""

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


class AllBackendsFailed(ReliabilityError):
    """Every rung of the fallback ladder failed (or was circuit-open) for
    this dispatch. ``__cause__`` holds the last underlying failure."""

    def __init__(self, attempts: int, rungs: int):
        self.attempts = attempts
        self.rungs = rungs
        super().__init__(
            f"dispatch failed on all {rungs} fallback rung(s) "
            f"({attempts} attempt(s) total)"
        )


class EngineClosed(ReliabilityError):
    """The engine shut down before this request could be dispatched."""
