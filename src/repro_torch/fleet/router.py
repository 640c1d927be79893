"""The fleet router: sticky stream affinity, admission, backpressure (the
port of ``repro/fleet/router.py``).

Request path (see the package docstring for the full architecture):

  submit(frame, stream_id)
    -> admission: ``reliability.validate_frame`` host-side, once, at the
       front door (workers run with ``admission_checks=False``)
    -> placement: the **affinity table** for stream traffic (sticky), the
       least-loaded live worker for stateless frames
    -> backpressure: the target worker's undispatched backlog is checked
       against ``max_worker_queue`` *before* the hand-off; at the bound the
       frame is shed with structured :class:`FleetSaturated`: the router
       sheds first, so a worker's own (larger) request queue never
       overflows and ``submit(block=True)`` can never wedge the caller on
       a saturated fleet
    -> hand-off: ``worker.submit`` returns the client's Future unchanged.

Affinity rules: placement is rendezvous (highest-random-weight) hashing
over the live workers: deterministic, and removing a worker re-places
*only* that worker's streams. The chosen worker is recorded in an explicit
``{stream_id: wid}`` affinity table at ``open_stream`` and **never
recomputed while the stream is warm**: a temporal carry is a bit-product of
one worker's dispatch sequence, so silent migration would splice two
recursions. The only path that moves a stream is :meth:`fail_worker`,
which first resets the carry through ``MultiStreamPacker.quarantine``:
every migration in ``rebalance_log`` is therefore preceded by a quarantine.

Failure semantics: a worker death (watchdog detection, submit-path
``WorkerDown``/``EngineClosed``, or a tripped :class:`WorkerHealth`
breaker) triggers drain-and-quarantine: kill the worker (queued futures
fail with structured ``EngineClosed``), quarantine its warm streams, re-pin
all its streams cold onto survivors. Degradation is one warm-up per warm
victim stream; survivors' carries are untouched.

Snapshot-restore: when the dead worker's backend shipped warm-carry
snapshots (``SubprocessWorker`` always; ``LocalWorker(snapshots=True)``),
:meth:`fail_worker` upgrades the cold re-pin: each victim's most recent
snapshot is **collected before the quarantine step**, validated (same
``plan_hash``; age within ``restore_max_age_s``), and installed onto the
rendezvous survivor *under the router lock, immediately after
``open_stream`` and before any frame can route there*, all-or-nothing per
stream via ``MultiStreamPacker.restore_carry``. A stale, foreign-hash,
missing, or failed-to-install snapshot falls back to the cold quarantine
path unchanged. Restores count in ``restores`` (with an at-restore
staleness sample), cold losses in ``quarantined_streams``: the two are
disjoint.

Rolling restarts: :meth:`replace_worker` swaps a *dead* slot for a fresh
worker (rebuilt from the construction-time factory when the router was
built from a controller), re-arming its health breaker; :meth:`crash_worker`
is the unannounced SIGKILL of a subprocess worker.

Port note: the workers' device goes in ``worker_kwargs`` (``device=``, the
card unless ``"cpu"`` is asked for), beside the mesh the JAX router's
workers take (``mesh=``, ``"auto"`` by default).
"""
from __future__ import annotations

import hashlib
import queue
import threading
import time
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.reliability import EngineClosed, validate_frame

from .errors import FleetSaturated, PlanMismatch, WorkerDown
from .health import FleetWatchdog, WorkerHealth
from .worker import LocalWorker, Worker

__all__ = ["FleetRouter"]

# Caller bugs pass through unwrapped (same contract as GuardedDispatch):
# retrying or rebalancing a bad request masks the traceback.
_CLIENT_ERRORS = (KeyError, ValueError, TypeError)


def _rendezvous_score(wid: Hashable, sid: Hashable) -> bytes:
    return hashlib.sha256(f"{wid!r}|{sid!r}".encode()).digest()


class FleetRouter:
    """Routes frames across N workers serving one compiled dispatch plan."""

    def __init__(
        self,
        workers: Optional[Sequence[Worker]] = None,
        *,
        controller=None,
        n_workers: Optional[int] = None,
        max_worker_queue: int = 64,
        admission_checks: bool = True,
        health_interval_s: Optional[float] = 0.5,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        worker_kwargs: Optional[dict] = None,
        worker_backend: str = "local",
        restore_max_age_s: float = 5.0,
    ):
        """Either hand explicit ``workers`` or a ``controller`` +
        ``n_workers`` and the router builds workers from the controller's
        single payload (``worker_kwargs`` passes through).
        ``worker_backend`` picks the controller-built class: ``"local"``
        (thread-hosted :class:`LocalWorker`) or ``"subprocess"``
        (process-isolated :class:`~repro_torch.fleet.remote.SubprocessWorker`).
        ``max_worker_queue`` is the router's per-worker backlog bound —
        keep it below the workers' own ``max_queue`` so the router always
        sheds first. ``health_interval_s=None`` disables the watchdog
        thread (failures are still detected on the submit path).
        ``restore_max_age_s`` bounds snapshot staleness on failover: an
        older warm-carry snapshot is worse than a cold restart (the EMA
        would resume from history the live stream has left behind), so it
        falls back to quarantine."""
        if restore_max_age_s <= 0:
            raise ValueError(
                f"restore_max_age_s must be > 0, got {restore_max_age_s}"
            )
        self.restore_max_age_s = restore_max_age_s
        self._worker_factory = None
        if workers is None:
            if controller is None or n_workers is None:
                raise TypeError(
                    "FleetRouter needs workers= or (controller=, n_workers=)"
                )
            if n_workers < 1:
                raise ValueError(f"n_workers must be >= 1, got {n_workers}")
            if worker_backend == "local":
                worker_cls = LocalWorker
            elif worker_backend == "subprocess":
                from .remote import SubprocessWorker

                worker_cls = SubprocessWorker
            else:
                raise ValueError(
                    f"worker_backend must be 'local' or 'subprocess', "
                    f"got {worker_backend!r}"
                )
            payload = controller.payload()
            # kept for replace_worker: a rolling restart rebuilds a dead
            # slot from the exact construction-time recipe
            self._worker_factory = lambda wid: worker_cls(
                wid, payload, **(worker_kwargs or {})
            )
            workers = []
            try:
                for i in range(n_workers):
                    workers.append(self._worker_factory(i))
            except BaseException:
                for w in workers:  # no half-built fleet keeps its workers
                    w.close(timeout=0.0)
                raise
        self.workers: Tuple[Worker, ...] = tuple(workers)
        if not self.workers:
            raise ValueError("FleetRouter needs at least one worker")
        self._by_wid = {w.wid: w for w in self.workers}
        if len(self._by_wid) != len(self.workers):
            raise ValueError("duplicate worker wids")
        hashes = {w.plan_hash for w in self.workers}
        if len(hashes) != 1:
            # refused at construction: temporal carries are not portable
            # across dispatch geometries, so a mixed fleet could corrupt
            # streams on the first rebalance
            raise PlanMismatch(
                f"mixed-plan fleet: workers disagree on plan_hash "
                f"({sorted(hashes)}) — all workers must be built from one "
                f"controller payload"
            )
        self.plan_hash: str = next(iter(hashes))
        if controller is not None:
            controller.verify(self.workers)
        self.controller = controller
        self.temporal = bool(self.workers[0].temporal)
        if max_worker_queue < 1:
            raise ValueError(
                f"max_worker_queue must be >= 1, got {max_worker_queue}"
            )
        self.max_worker_queue = max_worker_queue
        self.admission_checks = admission_checks

        self._lock = threading.RLock()
        self._affinity: Dict[Hashable, Hashable] = {}  # sid -> wid (sticky)
        self._alphas: Dict[Hashable, float] = {}
        self._dead: set = set()
        self._closed = False
        self._rr = 0  # stateless round-robin tiebreak
        self._router_shed = 0
        self._rebalanced = 0
        self._quarantined = 0
        self._workers_lost = 0
        self._restores = 0
        self._restore_staleness: List[float] = []  # at-restore ages (s)
        self._worker_restarts = 0
        self._reconnects_retired = 0  # banked from replaced workers
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        # every migration ever: (sid, old_wid, new_wid) — all of them pass
        # through fail_worker's quarantine, the affinity invariant's proof
        self.rebalance_log: List[Tuple[Hashable, Hashable, Hashable]] = []
        self._health = {
            w.wid: WorkerHealth(breaker_threshold, breaker_cooldown_s)
            for w in self.workers
        }
        self._watchdog = (
            None
            if health_interval_s is None
            else FleetWatchdog(self, interval_s=health_interval_s)
        )

    # ----------------------------------------------------------- placement
    def _place_locked(self, sid: Hashable) -> Worker:
        """Rendezvous placement over live workers (call with lock held):
        deterministic, and a worker's removal re-places only its own
        streams — every survivor keeps its rendezvous winners."""
        alive = [w for w in self.workers if w.wid not in self._dead]
        if not alive:
            raise WorkerDown(None, "no live workers to place on")
        return max(alive, key=lambda w: _rendezvous_score(w.wid, sid))

    def is_dead(self, wid: Hashable) -> bool:
        with self._lock:
            return wid in self._dead

    @property
    def workers_alive(self) -> int:
        with self._lock:
            return len(self.workers) - len(self._dead)

    # ------------------------------------------------------------- streams
    def open_stream(self, sid: Hashable, alpha: float = 0.0) -> Hashable:
        """Open ``sid`` on its rendezvous-placed worker and pin it there
        (the sticky affinity entry). Returns the worker id."""
        with self._lock:
            if self._closed:
                raise EngineClosed("router is closed")
            if sid in self._affinity:
                raise ValueError(f"stream {sid!r} already open on this fleet")
            worker = self._place_locked(sid)
            worker.open_stream(sid, alpha=alpha)
            self._affinity[sid] = worker.wid
            self._alphas[sid] = float(alpha)
            return worker.wid

    def close_stream(self, sid: Hashable) -> None:
        with self._lock:
            wid = self._affinity.pop(sid, None)
            self._alphas.pop(sid, None)
            if wid is None:
                raise KeyError(f"stream {sid!r} is not open on this fleet")
            if wid not in self._dead:
                self._by_wid[wid].close_stream(sid)

    def stream_worker(self, sid: Hashable) -> Hashable:
        """The affinity table entry for ``sid`` (KeyError when not open)."""
        with self._lock:
            return self._affinity[sid]

    @property
    def streams(self) -> int:
        with self._lock:
            return len(self._affinity)

    # ------------------------------------------------------------- serving
    def submit(
        self,
        frame,
        stream_id: Optional[Hashable] = None,
        deadline_ms: Optional[float] = None,
        block: bool = True,
        timeout: Optional[float] = None,
    ):
        """Route one frame; returns the serving worker's Future.

        Raises ``AdmissionError`` for malformed/non-finite frames,
        ``KeyError`` for an unopened stream, :class:`FleetSaturated` when
        the target worker's backlog is at the router's bound, and
        :class:`WorkerDown` only when no live worker remains.
        """
        with self._lock:
            if self._closed:
                raise EngineClosed("router is closed")
        if self.admission_checks:
            frame = validate_frame(frame, stream_id=stream_id)
        if stream_id is not None:
            return self._submit_stream(
                frame, stream_id, deadline_ms, block, timeout
            )
        return self._submit_stateless(frame, deadline_ms, block, timeout)

    def _shed(self, stream_id, wid, depth) -> FleetSaturated:
        with self._lock:
            self._router_shed += 1
        return FleetSaturated(stream_id, wid, depth, self.max_worker_queue)

    def _submit_to(self, worker: Worker, frame, stream_id, deadline_ms,
                   block, timeout):
        """One guarded hand-off. Returns a Future, raises FleetSaturated,
        re-raises caller errors, or raises ``WorkerDown`` after evacuating a
        worker that proved dead/sick (the caller retries on the new pin)."""
        depth = worker.queue_depth()
        if depth >= self.max_worker_queue:
            raise self._shed(stream_id, worker.wid, depth)
        try:
            fut = worker.submit(
                frame, stream_id=stream_id, deadline_ms=deadline_ms,
                block=block, timeout=timeout,
            )
        except queue.Full:
            # lost the race with other submitters between the depth check
            # and the hand-off; still shed structurally at the router
            raise self._shed(stream_id, worker.wid, worker.queue_depth()) \
                from None
        except _CLIENT_ERRORS:
            raise  # caller bug: no rebalance, original traceback
        except (WorkerDown, EngineClosed) as exc:
            self.fail_worker(worker.wid)
            raise WorkerDown(worker.wid, "evacuated after death") from exc
        except Exception as exc:
            if self._health[worker.wid].record_failure():
                # breaker just opened: a limping worker (every submit
                # erroring) is evacuated like a dead one
                self.fail_worker(worker.wid)
                raise WorkerDown(
                    worker.wid, "evacuated after repeated failures"
                ) from exc
            raise
        self._health[worker.wid].record_success()
        return fut

    def _submit_stream(self, frame, stream_id, deadline_ms, block, timeout):
        last: Optional[Exception] = None
        # each failed pass evacuates a worker, so attempts are bounded
        for _ in range(len(self.workers)):
            with self._lock:
                wid = self._affinity.get(stream_id)
                if wid is None:
                    raise KeyError(
                        f"stream {stream_id!r} is not open on this fleet"
                    )
                worker = self._by_wid[wid]
            try:
                return self._submit_to(
                    worker, frame, stream_id, deadline_ms, block, timeout
                )
            except WorkerDown as exc:
                # the stream was re-pinned (cold) by fail_worker; retry on
                # the survivor unless the fleet is gone
                last = exc
                if self.workers_alive == 0:
                    raise
        raise WorkerDown(None, "no surviving worker accepted the frame") \
            from last

    def _submit_stateless(self, frame, deadline_ms, block, timeout):
        if self.temporal:
            raise ValueError(
                "temporal fleet: submit needs a stream_id (open_stream "
                "first) — stateless frames have no carry to pin"
            )
        last: Optional[Exception] = None
        for _ in range(len(self.workers)):
            with self._lock:
                alive = [w for w in self.workers if w.wid not in self._dead]
                if not alive:
                    raise WorkerDown(None, "no workers alive")
                self._rr += 1
                rot = self._rr % len(alive)
            # least-loaded placement; the rotation breaks ties so an idle
            # fleet spreads instead of dog-piling worker 0
            order = alive[rot:] + alive[:rot]
            worker = min(order, key=lambda w: w.queue_depth())
            try:
                return self._submit_to(
                    worker, frame, None, deadline_ms, block, timeout
                )
            except WorkerDown as exc:
                last = exc
                if self.workers_alive == 0:
                    raise
        raise WorkerDown(None, "no surviving worker accepted the frame") \
            from last

    # -------------------------------------------------------------- health
    def fail_worker(self, wid: Hashable) -> List[Tuple[Hashable, Hashable]]:
        """Drain-and-restore-or-quarantine one worker (idempotent). Returns
        the ``[(sid, new_wid), ...]`` re-pins.

        Order matters: (1) kill the worker first — intake stops and queued
        futures fail structurally, so no pack can still be advancing
        carries underneath us; (2) **collect each warm victim's snapshot**
        (``worker.carry_snapshot`` — the parent-side store for subprocess
        workers, a live read for ``LocalWorker(snapshots=True)``, ``None``
        for the default backend) *before* the quarantine step destroys the
        state a live read would serve; (3) quarantine the warm streams on
        the dead worker (their carries there are unusable either way);
        (4) under the lock, re-pin every victim onto its rendezvous
        survivor and — when a valid snapshot exists (same plan hash, age
        within ``restore_max_age_s``) — restore it all-or-nothing right
        after ``open_stream``, before any frame can route to the survivor.
        Failed/stale/missing snapshots fall back to the cold re-pin
        (counted in ``quarantined_streams``); successes count in
        ``restores``. Survivors' streams never move (rendezvous property).
        """
        with self._lock:
            if wid not in self._by_wid:
                raise KeyError(f"unknown worker {wid!r}")
            if wid in self._dead:
                return []
            self._dead.add(wid)
            self._workers_lost += 1
            victims = sorted(
                (sid for sid, owner in self._affinity.items() if owner == wid),
                key=repr,
            )
        worker = self._by_wid[wid]
        try:
            worker.kill()
        except Exception:
            pass  # already dead is fine; state is torn down best-effort
        try:
            warm = set(worker.warm_streams())
        except Exception:
            warm = set(victims)  # state unreadable: assume every carry lost
        # (2) snapshot collection MUST precede quarantine: for snapshot
        # backends that read live state, quarantine would destroy exactly
        # what we are about to restore
        now = time.monotonic()
        snaps = {}
        for sid in victims:
            if sid not in warm:
                continue
            try:
                snap = worker.carry_snapshot(sid)
            except Exception:
                snap = None
            if snap is None:
                continue
            if snap.plan_hash != self.plan_hash:
                continue  # foreign dispatch geometry: never restorable
            if snap.age_s(now) > self.restore_max_age_s:
                continue  # staler than a cold restart is worth
            snaps[sid] = snap
        for sid in victims:
            if sid in warm:
                try:
                    worker.quarantine(sid)
                except Exception:
                    pass  # the carry dies with the worker either way
        moved: List[Tuple[Hashable, Hashable]] = []
        with self._lock:
            for sid in victims:
                new_worker = self._place_locked(sid)
                new_worker.open_stream(sid, self._alphas.get(sid, 0.0))
                restored = False
                snap = snaps.get(sid)
                if snap is not None:
                    try:
                        # all-or-nothing: a False/raise leaves the survivor
                        # stream exactly as open_stream made it (cold)
                        restored = bool(new_worker.restore_carry(sid, snap))
                    except Exception:
                        restored = False
                self._affinity[sid] = new_worker.wid
                self._rebalanced += 1
                if restored:
                    self._restores += 1
                    self._restore_staleness.append(snap.age_s())
                elif sid in warm:
                    self._quarantined += 1
                self.rebalance_log.append((sid, wid, new_worker.wid))
                moved.append((sid, new_worker.wid))
        return moved

    def kill_worker(self, wid: Hashable) -> None:
        """Chaos hook: crash one worker *without* telling the router — the
        watchdog (or the submit path) must notice on its own."""
        self._by_wid[wid].kill()

    def crash_worker(self, wid: Hashable) -> None:
        """Harder chaos hook: for process-isolated workers, SIGKILL the
        worker *process* with zero parent-side bookkeeping (the backend's
        liveness machinery must detect it cold). Thread-hosted backends
        have no harder crash than
        ``kill()``, so it falls back to :meth:`kill_worker` semantics."""
        worker = self._by_wid[wid]
        crash = getattr(worker, "crash", None)
        if crash is not None:
            crash()
        else:
            worker.kill()

    def replace_worker(self, wid: Hashable, worker: Optional[Worker] = None):
        """Swap a **dead** slot for a fresh worker (the rolling-restart
        lever). With ``worker=None`` the router rebuilds from its
        construction-time factory (requires controller-built construction);
        an explicit ``worker`` must carry the same ``wid`` and plan hash.
        The slot returns to rotation with a re-armed health breaker; the
        restart is counted in ``worker_restarts``. Streams do *not* move
        back — rendezvous placement will route *new* streams to the slot,
        and existing pins stay where failover put them (sticky affinity is
        never recomputed for live streams)."""
        with self._lock:
            if wid not in self._by_wid:
                raise KeyError(f"unknown worker {wid!r}")
            if wid not in self._dead:
                raise ValueError(
                    f"worker {wid!r} is not dead — fail_worker first "
                    f"(replacing a live worker would strand its streams)"
                )
        if worker is None:
            if self._worker_factory is None:
                raise ValueError(
                    "no worker factory: this router was built from explicit "
                    "workers= — pass a replacement worker"
                )
            worker = self._worker_factory(wid)
        if worker.wid != wid:
            raise ValueError(
                f"replacement wid {worker.wid!r} does not match slot {wid!r}"
            )
        if worker.plan_hash != self.plan_hash:
            raise PlanMismatch(
                f"replacement worker {wid!r} serves plan "
                f"{worker.plan_hash!r}, fleet runs {self.plan_hash!r}"
            )
        with self._lock:
            # retired workers leave the tuple; bank their transport counters
            # so fleet-lifetime telemetry survives the swap
            old = self._by_wid[wid]
            self._reconnects_retired += getattr(old, "reconnects", 0)
            self.workers = tuple(
                worker if w.wid == wid else w for w in self.workers
            )
            self._by_wid[wid] = worker
            self._dead.discard(wid)
            self._health[wid] = WorkerHealth(
                self._breaker_threshold, self._breaker_cooldown_s
            )
            self._worker_restarts += 1
        try:
            old.close(timeout=0.0)  # release sockets/tmpdirs/threads now
        except Exception:
            pass
        return worker

    # ----------------------------------------------------------- telemetry
    @property
    def router_shed(self) -> int:
        return self._router_shed

    @property
    def rebalanced_streams(self) -> int:
        return self._rebalanced

    @property
    def quarantined_streams(self) -> int:
        return self._quarantined

    @property
    def workers_lost(self) -> int:
        return self._workers_lost

    @property
    def restores(self) -> int:
        """Warm carries restored from snapshots on failover (the streams
        that did *not* pay a cold warm-up for their worker's death)."""
        return self._restores

    @property
    def worker_restarts(self) -> int:
        return self._worker_restarts

    @property
    def restore_staleness_samples(self) -> Tuple[float, ...]:
        """At-restore snapshot ages (seconds), one per restore."""
        with self._lock:
            return tuple(self._restore_staleness)

    @property
    def reconnects(self) -> int:
        """Transport reconnects across the fleet's lifetime (subprocess
        backends; includes workers since retired by replace_worker)."""
        with self._lock:
            return self._reconnects_retired + sum(
                getattr(w, "reconnects", 0) for w in self.workers
            )

    def stats(self):
        """Fleet-wide :class:`~repro_torch.fleet.stats.FleetStats` snapshot."""
        from .stats import FleetStats

        return FleetStats.collect(self)

    # ------------------------------------------------------------ shutdown
    def flush(self, timeout: Optional[float] = None) -> bool:
        ok = True
        for w in self.workers:
            if not self.is_dead(w.wid):
                ok = w.flush(timeout=timeout) and ok
        return ok

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._watchdog is not None:
            self._watchdog.stop()
        for w in self.workers:
            if not self.is_dead(w.wid):
                w.close(timeout=timeout)
            else:
                try:
                    # dead workers still own transport resources (sockets,
                    # tmpdirs, sweep threads for subprocess backends)
                    w.close(timeout=0.0)
                except Exception:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
