"""The fleet worker protocol + the thread-hosted in-process worker: the port
of ``repro/fleet/worker.py``.

:class:`Worker` is the narrow surface the router and watchdog talk to: a
handful of methods that all travel as plain data (a plan payload in, frames
and futures out, counters back). Nothing in the protocol assumes the worker
shares the router's process: the process-spanning backend
(:class:`~repro_torch.fleet.remote.SubprocessWorker`, sockets + the frame
codec) implements the same methods and slots in unchanged.
:class:`LocalWorker` hosts a full
:class:`~repro_torch.serving.AsyncFrameEngine` (dispatch + completion
threads) in the router's process.

A worker never resolves its own plan: it is *handed* a controller payload
(``PlanController.payload()``: a ``BGPlan.to_json`` dict plus the
controller's ``plan_hash``), rebuilds the plan with ``BGPlan.from_json``
on its own device, and refuses the payload when its own hash of the
rebuilt plan disagrees: the worker-side half of the fleet's
identical-recipe contract. Equal plans share one executable
(``repro_torch.plan._plan_executable`` is keyed on plan equality) and every
worker of a process calls the same loaded kernel library (one
``kernels/_build`` load per source), so N local workers cost one build.

Admission runs once, at the router (``validate_frame``), so workers are
built with ``admission_checks=False``: the protocol's equivalent of a
trusted internal network behind a validating front door.

Where the port differs from the JAX worker: it takes ``device=`` (the card
unless ``"cpu"`` is asked for) beside the JAX worker's ``mesh=``
(``"auto"``: a payload's ``mesh_size`` over this host's first cards,
``ValueError`` when it has fewer; a ``BatchMesh`` or ``None`` rebinds, and
the rebuilt plan must still hash as the payload claims), and its futures
hold tensors on the plan's device (a mesh plan's first).
A carry snapshot is host data in the plan's storage type: a float32 numpy
array for fp32, a CPU ``torch.bfloat16`` tensor for bf16 (numpy has no
bfloat16), so a bf16 fleet ships half the carry bytes, as the JAX fleet
does with its ``ml_dtypes`` arrays.
"""
from __future__ import annotations

import abc
import dataclasses
import threading
import time
from typing import Dict, Hashable, List, Optional

import numpy as np
import torch

from repro_torch.plan import BGPlan
from repro_torch.serving import AsyncFrameEngine, EngineStats
from repro_torch.video import MultiStreamPacker

from .errors import PlanMismatch, WorkerDown

__all__ = ["Worker", "LocalWorker", "CarrySnapshot"]

# the kernel sources (``kernels/csrc/<name>.cu``) each plan backend launches
_BACKEND_SOURCES = {
    "fused": ("bg_fused",),
    "fused_streamed": ("bg_fused_streamed",),
    "staged": ("bg_create", "bg_blur", "bg_slice"),
}


@dataclasses.dataclass(frozen=True)
class CarrySnapshot:
    """One warm stream's temporal state, frozen as host data.

    This is what travels from a worker to the router (periodically, over
    the snapshot channel) and from the router to a rendezvous survivor on
    failover. ``carry`` is a float32 numpy array, or a CPU
    ``torch.bfloat16`` tensor for a bf16 plan (a JAX worker's snapshot,
    numpy float32 or ``ml_dtypes`` bfloat16, restores too). ``plan_hash``
    stamps the dispatch geometry the carry was produced under: the router
    refuses to restore a snapshot onto a worker with a different hash (a
    foreign-geometry carry would silently corrupt the stream's EMA).
    ``taken_at`` (``time.monotonic()`` in the *router's* clock: snapshots
    are stamped on receipt, so child/parent clock skew cannot fake
    freshness) bounds staleness: restoring an ancient carry is worse than
    a cold restart, so ``FleetRouter.restore_max_age_s`` gates it.
    """

    sid: Hashable
    carry: object
    alpha: float
    frames_seen: int
    plan_hash: str
    taken_at: float

    def age_s(self, now: Optional[float] = None) -> float:
        return (time.monotonic() if now is None else now) - self.taken_at


class Worker(abc.ABC):
    """What the router needs from a worker: implementable across a process
    boundary (every argument and return value is plain data or a Future)."""

    wid: Hashable

    @property
    @abc.abstractmethod
    def plan_hash(self) -> str:
        """Hash of the dispatch recipe this worker serves."""

    @property
    @abc.abstractmethod
    def temporal(self) -> bool:
        """True when the worker carries per-stream temporal state."""

    @abc.abstractmethod
    def open_stream(self, sid: Hashable, alpha: float = 0.0) -> None:
        """Create (cold) per-stream state for ``sid``."""

    @abc.abstractmethod
    def close_stream(self, sid: Hashable) -> None:
        """Drop ``sid``'s state."""

    @abc.abstractmethod
    def submit(self, frame, stream_id=None, deadline_ms=None, block=True,
               timeout=None):
        """Queue one frame; returns a Future. Raises ``WorkerDown`` when the
        worker is dead, ``queue.Full`` when its own queue is at capacity."""

    @abc.abstractmethod
    def quarantine(self, sid: Hashable) -> bool:
        """Reset ``sid``'s temporal carry to cold; True if one was dropped."""

    @abc.abstractmethod
    def warm_streams(self) -> List[Hashable]:
        """Streams currently holding a temporal carry."""

    @abc.abstractmethod
    def queue_depth(self) -> int:
        """Undispatched backlog (the router's backpressure signal)."""

    @abc.abstractmethod
    def stats(self) -> EngineStats:
        """Lifetime engine telemetry snapshot."""

    @abc.abstractmethod
    def launches(self) -> Dict[str, int]:
        """Kernel launches of this worker's engine, by counter
        (``"bg_fused.temporal_launches"``, ...; empty on the CPU)."""

    @abc.abstractmethod
    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted frame has resolved."""

    @abc.abstractmethod
    def healthy(self) -> bool:
        """Liveness: False once the worker can no longer serve."""

    @abc.abstractmethod
    def kill(self) -> None:
        """Abrupt death (the chaos hook): stop serving *now*; queued
        futures fail structurally rather than hang."""

    @abc.abstractmethod
    def close(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: drain, then stop."""

    # Snapshot/restore is optional: the base protocol answers "no snapshot"
    # so a backend without it keeps cold-quarantine failover.
    def carry_snapshot(self, sid: Hashable) -> Optional[CarrySnapshot]:
        """Most recent warm-carry snapshot for ``sid``, or ``None``. Must
        stay answerable *after* the worker dies (the router calls it from
        ``fail_worker``), so subprocess backends serve it from the
        router-side snapshot store, not an RPC."""
        return None

    def restore_carry(self, sid: Hashable, snap: CarrySnapshot) -> bool:
        """Install a snapshot onto an open stream; True on success. The
        default backend cannot restore, so failover falls through to the
        cold-quarantine path."""
        return False


class LocalWorker(Worker):
    """Thread-hosted worker: one ``AsyncFrameEngine`` (plus, for temporal
    plans, its ``MultiStreamPacker``) behind the :class:`Worker` protocol.

    ``device`` is where the plan runs: ``None`` is the CUDA card (raising
    when there is none), ``"cpu"`` runs the plain versions. ``mesh`` binds a
    payload's mesh (``BGPlan.from_json``): ``"auto"`` over this host's
    cards, or a :class:`repro_torch.sharding.BatchMesh` whose first device
    is ``device`` (or with ``device=None``).
    ``streams_served`` counts accepted submissions per stream: the
    router's affinity invariant ("a warm stream never runs on two workers
    without an intervening quarantine") is asserted against it in tests.
    """

    def __init__(
        self,
        wid: Hashable,
        payload: dict,
        *,
        device=None,
        mesh="auto",
        max_batch: int = 32,
        max_queue: int = 256,
        batch_window_ms: float = 2.0,
        watchdog_ms: Optional[float] = None,
        fault_injector=None,
        engine_kwargs: Optional[dict] = None,
        snapshots: bool = False,
    ):
        self.wid = wid
        # snapshots=False: a dead worker's carries are gone (cold
        # quarantine); True enables live-read snapshots so the router's
        # restore path runs without a subprocess.
        self.snapshots = bool(snapshots)
        plan = BGPlan.from_json(payload["plan"], mesh=mesh, device=device)
        want = payload.get("plan_hash")
        if want is not None and plan.plan_hash() != want:
            raise PlanMismatch(
                f"worker {wid!r}: rebuilt plan hashes to "
                f"{plan.plan_hash()}, controller payload claims {want!r}"
            )
        self.plan = plan
        self._hash = plan.plan_hash()
        kw = dict(
            max_batch=max_batch,
            max_queue=max_queue,
            batch_window_ms=batch_window_ms,
            watchdog_ms=watchdog_ms,
            fault_injector=fault_injector,
            admission_checks=False,  # the router validated at its front door
        )
        kw.update(engine_kwargs or {})
        if plan.temporal:
            self.packer = MultiStreamPacker(plan=plan)
            self.engine = AsyncFrameEngine(packer=self.packer, **kw)
        else:
            self.packer = None
            self.engine = AsyncFrameEngine(plan=plan, **kw)
        self.streams_served: Dict[Hashable, int] = {}
        self._alphas: Dict[Hashable, float] = {}
        self._killed = False
        self._lock = threading.Lock()

    def load_kernels(self) -> tuple:
        """Build (if the checkout has no build) and load the kernel
        libraries that the plan's fallback ladder launches, so that no
        dispatch waits on ``nvcc``; nothing on the CPU. Returns the sources
        loaded."""
        if self.plan.device.type != "cuda":
            return ()
        from repro_torch.kernels import _build

        names = tuple(dict.fromkeys(
            src for rung in self.plan.fallback_ladder()
            for src in _BACKEND_SOURCES.get(rung.backend, ())
        ))
        _build.build_all(names)  # one nvcc per missing source, together
        for name in names:
            _build.load(name)
        return names

    # ---------------------------------------------------------------- plan
    @property
    def plan_hash(self) -> str:
        return self._hash

    @property
    def temporal(self) -> bool:
        return self.plan.temporal

    # ------------------------------------------------------------- streams
    def open_stream(self, sid: Hashable, alpha: float = 0.0) -> None:
        with self._lock:
            if self._killed:
                raise WorkerDown(self.wid, "open_stream on a dead worker")
            self._alphas[sid] = float(alpha)
        if self.packer is not None:
            with self.engine._packer_lock:
                self.packer.open(sid, alpha=alpha)

    def close_stream(self, sid: Hashable) -> None:
        with self._lock:
            self._alphas.pop(sid, None)
        if self.packer is not None:
            with self.engine._packer_lock:
                self.packer.close(sid)

    def quarantine(self, sid: Hashable) -> bool:
        if self.packer is None:
            return False
        before = self.packer.carry_resets
        # the engine's quarantine path: the packer's cold-restart machinery
        # under the pack lock, counted in EngineStats.carry_resets
        self.engine._quarantine([sid])
        return self.packer.carry_resets > before

    def warm_streams(self) -> List[Hashable]:
        if self.packer is None:
            return []
        # dict iteration under the GIL; best-effort snapshot (the router
        # only reads this after it has stopped routing to the worker)
        return [
            sid for sid, sess in list(self.packer.sessions.items())
            if sess.carry is not None
        ]

    # ----------------------------------------------------------- snapshots
    def carry_snapshot(self, sid: Hashable) -> Optional[CarrySnapshot]:
        """Live read of ``sid``'s current carry (thread backend: the state
        survives ``kill()`` because the process does), copied to the host
        in the plan's storage type. ``snapshots=False`` (the default)
        answers ``None``: the cold-quarantine fleet."""
        if not self.snapshots or self.packer is None:
            return None
        sess = self.packer.sessions.get(sid)
        carry = None if sess is None else sess.carry
        if carry is None:
            return None
        # the copy waits on the stream the carry was made on: a carry is
        # replaced by each pack, never written in place
        host = carry.detach().to("cpu", copy=True)
        return CarrySnapshot(
            sid=sid,
            carry=host if host.dtype == torch.bfloat16 else host.numpy(),
            alpha=sess.alpha,
            frames_seen=sess.frames_seen,
            plan_hash=self._hash,
            taken_at=time.monotonic(),
        )

    def restore_carry(self, sid: Hashable, snap: CarrySnapshot) -> bool:
        """All-or-nothing install via ``MultiStreamPacker.restore_carry``
        (which validates geometry/finiteness before assigning anything).
        A failed restore leaves the stream cold and returns False."""
        if self.packer is None:
            return False
        if snap.plan_hash != self._hash:
            return False
        try:
            with self.engine._packer_lock:
                self.packer.restore_carry(
                    sid, snap.carry, alpha=snap.alpha,
                    frames_seen=snap.frames_seen,
                )
        except (KeyError, ValueError):
            return False
        return True

    # ------------------------------------------------------------- serving
    def submit(self, frame, stream_id=None, deadline_ms=None, block=True,
               timeout=None):
        if self._killed:
            raise WorkerDown(self.wid, "submit on a dead worker")
        fut = self.engine.submit(
            frame, stream_id=stream_id, deadline_ms=deadline_ms,
            block=block, timeout=timeout,
        )
        if stream_id is not None:
            # counted only after the engine accepted the frame: the affinity
            # invariant is about frames that could actually touch state
            with self._lock:
                self.streams_served[stream_id] = (
                    self.streams_served.get(stream_id, 0) + 1
                )
        return fut

    def queue_depth(self) -> int:
        return self.engine._queue.qsize() + len(self.engine._held)

    def stats(self) -> EngineStats:
        return self.engine.stats()

    def launches(self) -> Dict[str, int]:
        return self.engine.launches()

    def flush(self, timeout: Optional[float] = None) -> bool:
        return self.engine.flush(timeout=timeout)

    # -------------------------------------------------------------- health
    def healthy(self) -> bool:
        return (
            not self._killed
            and self.engine._dispatcher.is_alive()
            and self.engine._completer.is_alive()
        )

    def kill(self) -> None:
        """Simulated crash: stop accepting immediately and give in-flight
        work a fraction of a second to resolve; whatever is still queued
        fails with structured ``EngineClosed`` (never a hanging future)."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
        self.engine.close(timeout=0.2)

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            self._killed = True
        self.engine.close(timeout=timeout)

    def __repr__(self):
        return (
            f"LocalWorker(wid={self.wid!r}, plan_hash={self._hash!r}, "
            f"device={self.plan.device}, healthy={self.healthy()})"
        )
