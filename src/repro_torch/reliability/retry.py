"""Bounded retry, circuit breaking and the backend fallback ladder: the port
of ``repro/reliability/retry.py``.

A transient dispatch failure (a flaky device, an injected fault, an
allocation that clears) should cost a retry, not a failed request; a
persistent backend failure should cost a downgrade, not an outage.
:class:`GuardedDispatch` composes the two around a ladder of
:class:`~repro_torch.plan.BGPlan` rungs (``BGPlan.fallback_ladder()``:
``fused_streamed -> fused -> reference`` on the CPU, ``fused_streamed ->
fused`` on a card):

  * per rung, up to ``max_attempts`` tries with exponential backoff
    (deterministic, no jitter);
  * a :class:`CircuitBreaker` per rung: ``breaker_threshold`` consecutive
    exhausted-rung failures open it for ``breaker_cooldown_s``, so a dead
    backend stops eating retry latency and traffic flows straight to the
    next rung (one probe per cooldown half-opens it);
  * the last rung is always allowed even when its breaker is open:
    degraded service beats refusing to serve;
  * caller errors (``KeyError`` / ``ValueError`` / ``TypeError``: a
    never-opened stream, a bad shape) fail fast with the original exception.

Two divergences from the JAX package, both so that plain PyTorch never
answers for a kernel on the card:

  * a failed kernel build or load
    (:class:`~repro_torch.reliability.errors.KernelBuildError`) or a CUDA
    error from a kernel's launch or from the wait on its completion
    (:class:`~repro_torch.reliability.errors.KernelLaunchError`) is
    re-raised at once, like a caller error: never retried and never served
    from a lower rung. The JAX package's kernels compile through XLA, and a
    failure there is the runtime's; here it is the port's own CUDA code
    failing, and a lower rung would hide it behind correct-looking frames;
  * a card plan's ladder ends at its last kernel rung
    (``BGPlan.fallback_ladder``): a ``fused`` or temporal plan on the card
    has no rung below it, so a fault that exhausts it fails the request
    with ``AllBackendsFailed``.

``call(fn)`` runs ``fn(plan)`` down the ladder and returns ``(result,
rung)``; ``record_remote_failure(rung)`` lets the engine charge
completion-side failures (watchdog timeouts) to the rung that dispatched
them, so a backend that launches fine but never finishes still trips its
breaker.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

from .errors import AllBackendsFailed, KernelBuildError, KernelLaunchError

__all__ = ["RetryPolicy", "CircuitBreaker", "GuardedDispatch"]

# Caller bugs: never retried, never downgraded, re-raised at once
# (AdmissionError is a ValueError; InjectedFault and EngineTimeout are
# RuntimeErrors and therefore retryable).
_CLIENT_ERRORS = (KeyError, ValueError, TypeError)
# The port's kernel failures: re-raised like caller errors (module docstring)
_KERNEL_ERRORS = (KernelBuildError, KernelLaunchError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry, backoff and breaker knobs for one :class:`GuardedDispatch`."""

    max_attempts: int = 3
    backoff_s: float = 0.005
    backoff_mult: float = 2.0
    max_backoff_s: float = 0.25
    breaker_threshold: int = 2
    breaker_cooldown_s: float = 30.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}"
            )
        if min(self.backoff_s, self.max_backoff_s, self.breaker_cooldown_s) < 0:
            raise ValueError("backoff/cooldown must be >= 0")


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    Closed until ``threshold`` consecutive failures; then open for
    ``cooldown_s`` (every ``allow()`` refused); then half-open (one probe
    allowed: success closes, failure re-opens). Thread-safe.
    """

    def __init__(self, threshold: int, cooldown_s: float, clock=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive = 0
        self._open_until: Optional[float] = None

    def allow(self) -> bool:
        with self._lock:
            if self._open_until is None:
                return True
            if self._clock() >= self._open_until:
                # half-open: let one probe through; a failure re-opens
                self._open_until = None
                self._consecutive = self.threshold - 1
                return True
            return False

    @property
    def open(self) -> bool:
        with self._lock:
            return self._open_until is not None and self._clock() < self._open_until

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._open_until = None

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._consecutive >= self.threshold:
                self._open_until = self._clock() + self.cooldown_s


class GuardedDispatch:
    """Retry + breaker + fallback around a ladder of plans.

    ``on_retry`` / ``on_fallback`` are telemetry callbacks (the engine counts
    them in ``EngineStats``): ``on_retry()`` fires per re-attempt,
    ``on_fallback()`` per dispatch served from a rung below the primary.
    ``sleep`` and ``clock`` are injectable for tests.
    """

    def __init__(
        self,
        ladder: Sequence,
        policy: Optional[RetryPolicy] = None,
        *,
        on_retry: Optional[Callable[[], None]] = None,
        on_fallback: Optional[Callable[[], None]] = None,
        sleep=time.sleep,
        clock=time.monotonic,
    ):
        self.ladder = tuple(ladder)
        if not self.ladder:
            raise ValueError("GuardedDispatch needs at least one plan")
        self.policy = policy if policy is not None else RetryPolicy()
        self.breakers = tuple(
            CircuitBreaker(self.policy.breaker_threshold, self.policy.breaker_cooldown_s,
                           clock=clock)
            for _ in self.ladder
        )
        self._on_retry = on_retry
        self._on_fallback = on_fallback
        self._sleep = sleep

    def record_remote_failure(self, rung: int) -> None:
        """Charge a completion-side failure (watchdog trip) to the rung
        whose dispatch produced it."""
        if 0 <= rung < len(self.breakers):
            self.breakers[rung].record_failure()

    def call(self, fn: Callable) -> Tuple[object, int]:
        """Run ``fn(plan)`` down the ladder; returns ``(result, rung)``.

        Re-raises caller errors and the port's kernel errors as they are,
        and raises :class:`AllBackendsFailed` (``__cause__`` = the last
        failure) when every admissible rung exhausts its attempts.
        """
        policy = self.policy
        last_exc: Optional[Exception] = None
        total_attempts = 0
        for rung, plan in enumerate(self.ladder):
            breaker = self.breakers[rung]
            # the last rung always serves
            if not breaker.allow() and rung < len(self.ladder) - 1:
                continue
            backoff = policy.backoff_s
            for attempt in range(policy.max_attempts):
                total_attempts += 1
                try:
                    result = fn(plan)
                except _CLIENT_ERRORS + _KERNEL_ERRORS:
                    raise  # no retry, no downgrade
                except Exception as exc:
                    last_exc = exc
                    if attempt + 1 < policy.max_attempts:
                        if self._on_retry is not None:
                            self._on_retry()
                        if backoff > 0:
                            self._sleep(backoff)
                        backoff = min(backoff * policy.backoff_mult, policy.max_backoff_s)
                    continue
                breaker.record_success()
                if rung > 0 and self._on_fallback is not None:
                    self._on_fallback()
                return result, rung
            breaker.record_failure()
        raise AllBackendsFailed(total_attempts, len(self.ladder)) from last_exc
