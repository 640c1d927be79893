"""Fleet health: per-worker circuit breakers + the liveness watchdog (the
port of ``repro/fleet/health.py``).

Two failure detectors, built on :mod:`repro_torch.reliability.retry`:

  * :class:`WorkerHealth` — a consecutive-failure
    :class:`~repro_torch.reliability.CircuitBreaker` per worker, charged by the
    router on every submit-side failure. The breaker *opening* is the
    "worker is sick" signal: the router then runs the same
    drain-and-quarantine path a hard death takes, so a worker that limps
    (every submit erroring) is evacuated instead of eating retries forever.
  * :class:`FleetWatchdog` — a daemon thread polling ``worker.healthy()``
    every ``interval_s``; a dead worker (killed, crashed threads) triggers
    ``router.fail_worker`` even when no traffic is flowing to notice. The
    router's failure handling is idempotent, so the watchdog and the
    submit-path detector racing on the same death is harmless.

Failure semantics (what ``fail_worker`` guarantees): each of the victim's
warm streams is re-pinned to its rendezvous survivor and either
**snapshot-restored** — the worker's most recent shipped warm-carry
snapshot (see ``repro_torch.fleet.remote``; ``LocalWorker(snapshots=True)`` for
the thread backend) is installed all-or-nothing when its plan hash matches
and its age is within the router's ``restore_max_age_s`` — or, when no
valid snapshot exists, reset through the ``MultiStreamPacker.quarantine``
cold-restart path (degraded quality for one warm-up, never a corrupt or
stale EMA; the carry *on the dead worker* is never read after death for
thread backends without snapshots). A worker loss therefore degrades at
most its own streams, each by at most one warm-up — zero for streams that
restore.

For process-isolated workers, ``worker.healthy()`` folds in child-process
liveness (``proc.poll()``) and heartbeat freshness, so this same poller
detects SIGKILLed and wedged worker *processes* with no new machinery.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.reliability import CircuitBreaker

__all__ = ["WorkerHealth", "FleetWatchdog"]


class WorkerHealth:
    """Submit-path failure accounting for one worker.

    ``record_failure`` returns True exactly when this failure opened the
    breaker — the router's cue to evacuate the worker. Successes close it,
    so transient blips (one flaky dispatch) never cost a rebalance.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0):
        self.breaker = CircuitBreaker(threshold, cooldown_s)

    def record_success(self) -> None:
        self.breaker.record_success()

    def record_failure(self) -> bool:
        was_open = self.breaker.open
        self.breaker.record_failure()
        return self.breaker.open and not was_open

    @property
    def tripped(self) -> bool:
        return self.breaker.open


class FleetWatchdog:
    """Daemon poller: ``worker.healthy()`` -> ``router.fail_worker``."""

    def __init__(self, router, interval_s: float = 0.2):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._router = router
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="bg-fleet-watchdog", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.poll()

    def poll(self) -> None:
        """One health sweep (also callable synchronously from tests)."""
        router = self._router
        for worker in router.workers:
            if router.is_dead(worker.wid):
                continue
            try:
                alive = worker.healthy()
            except Exception:
                alive = False
            if not alive:
                router.fail_worker(worker.wid)

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)
