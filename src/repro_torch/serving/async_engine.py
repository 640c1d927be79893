"""Async frame-denoise engine: pipelined host-to-device feeding behind futures.

The port of ``repro/serving/async_engine.py``. The loop of the synchronous
``frames.FrameDenoiseEngine`` is split across threads so the card does not
wait on host-side stacking and the host does not wait on the card:

  client threads    -- submit(frame) -> Future           (bounded queue)
  dispatch thread   -- collect a micro-batch, stack it into a pinned host
                       buffer, copy it to the card (non_blocking), launch,
                       record a CUDA event              -> in-flight queue
  completion thread -- wait on the batch's event, read its guard flags,
                       resolve the futures, record latency

The in-flight queue holds at most ``max_inflight`` launched batches; ``put``
on a full queue is the backpressure that keeps the host from racing ahead
of the card. Each in-flight item keeps its pinned buffer alive until the
batch completes, since the copy out of it is asynchronous. The completion
thread waits on the batch's own event, never on the whole device. Submission
backpressure is the bounded request queue: ``submit`` blocks (or raises
``queue.Full`` with ``block=False``) when ``max_queue`` requests are pending.

Micro-batching is deadline-aware: a batch dispatches when it is full, when
the batch window since its first frame expires, or when a queued request's
deadline is within ``deadline_margin_ms``. A request whose deadline has
already passed at collect time is shed with ``DeadlineExceeded``.

Video mode: constructed with a :class:`repro_torch.video.MultiStreamPacker`,
requests carry a ``stream_id`` and each micro-batch takes at most one frame
per stream (the temporal recursion is sequential within a stream); a
same-stream repeat is deferred to the next batch. Every pack is one
dispatch: the temporal kernel B2 when a stream of the pack is warm, the
per-frame kernel B1 otherwise.

Mesh plans (``mesh=`` on the legacy constructor, or a plan or packer whose
plan carries a ``repro_torch.sharding.BatchMesh``): the pinned staging is
not copied to the first card whole; each shard goes from it to its own
device (``repro_torch.plan._mesh_call``), as the JAX engine skips its
``device_put`` for mesh plans. The outputs are gathered on the first device,
a copy ordered after every shard's work, so the batch's event, recorded on
that device's stream after the dispatch, covers every shard.

Fault tolerance (the ``repro_torch.reliability`` wiring, as in the JAX
engine):

  * **Admission**: ``submit`` validates shape, dtype and finiteness on the
    host (``AdmissionError``). Disable with ``admission_checks=False`` (the
    fleet's workers do: their router validated at its front door).
  * **Guarded dispatch**: every launch runs through a
    ``reliability.GuardedDispatch``: bounded retries with backoff, then the
    plan's fallback ladder behind per-rung circuit breakers
    (``fused_streamed -> fused -> reference`` on the CPU; on a card the
    ladder ends at ``fused``, so plain PyTorch never serves a card plan;
    ``fallback=False`` keeps the primary rung alone). A transient fault
    costs a retry; a dead backend serves from the next rung, counted in
    ``fallbacks``. Caller errors fail fast, and so do the port's kernel
    errors (``KernelBuildError``, ``KernelLaunchError``, the latter also for
    a CUDA error the wait on a batch's completion reports): a kernel that
    does not build, launch or complete is never retried or hidden behind a
    lower rung.
  * **Finite-guards and carry quarantine**: each dispatch launches per-row
    ``isfinite`` flags over its outputs (and, in video mode, the advanced
    carries), read at completion: a non-finite output row fails exactly that
    request with ``NonFiniteOutput``, a bad carry row quarantines exactly
    that stream.
  * **Watchdog**: ``watchdog_ms`` bounds the completion wait of each
    in-flight batch, the wait on the batch's CUDA event (and the fault
    injector's completion hook) run in a helper thread joined with that
    timeout, the JAX engine's semantics. Past it the batch counts a
    ``watchdog_trips``, the dispatching rung's breaker records a failure,
    and the batch fails with ``EngineTimeout``, except that a stateless
    (non-video) batch first gets one synchronous guarded redispatch (a
    batch whose completion reported a CUDA error gets none). A
    kernel truly hung on the card cannot be cancelled from the host: the
    watchdog fails its requests structurally, it does not recover them, and
    work queued behind it on the same stream waits with it.
  * **Fault injection**: assign ``engine.fault_injector`` (a
    ``reliability.FaultInjector``) to fire a deterministic fault schedule at
    the hook points above.

Telemetry: ``stats()`` returns an :class:`EngineStats` snapshot;
``launches()`` the kernel launches made by this engine's threads, by
counter (so several engines in one process count apart).
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bilateral_grid import BGConfig
from repro_torch.kernels import _wrap
from repro_torch.reliability import (
    DeadlineExceeded,
    DispatchGuard,
    EngineClosed,
    EngineTimeout,
    GuardedDispatch,
    KernelBuildError,
    KernelLaunchError,
    NonFiniteOutput,
    RetryPolicy,
    finite_rows,
    validate_frame,
)

__all__ = ["AsyncFrameEngine", "AsyncFrameRequest", "EngineStats"]

_SENTINEL = object()


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Engine telemetry snapshot: counts are since engine start, depths are
    instantaneous, latencies (submit to completion) are over the last 4096
    completed requests.

    ``failed``: requests resolved with an exception (dispatch or completion
    failures, finite-guard rejections); ``retries``: guarded-dispatch
    re-attempts; ``fallbacks``: dispatches served from a fallback-ladder rung
    below the primary backend; ``carry_resets``: temporal carries
    quarantined back to cold; ``shed``: requests dropped at collect time
    because their deadline had passed; ``watchdog_trips``: in-flight batches
    that exceeded the completion watchdog; ``restores``: carries installed
    from a snapshot; ``reconnects``: transport connections re-established
    to a process-isolated fleet worker (0 for an in-process engine).
    ``latency_samples`` carries the sorted latency reservoir
    (ms) so :meth:`merge` computes exact percentiles over several engines;
    ``as_dict()`` leaves it out. ``stats["key"]`` indexing is kept.
    """

    submitted: int
    completed: int
    dispatches: int
    queue_depth: int
    inflight_depth: int
    deadline_misses: int
    mean_batch: float
    latency_ms_p50: float
    latency_ms_p99: float
    failed: int = 0
    retries: int = 0
    fallbacks: int = 0
    carry_resets: int = 0
    shed: int = 0
    watchdog_trips: int = 0
    restores: int = 0
    reconnects: int = 0
    latency_samples: Tuple[float, ...] = ()

    def __getitem__(self, key: str):
        if key not in self.__dataclass_fields__:
            raise KeyError(key)
        return getattr(self, key)

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d.pop("latency_samples")
        return d

    @classmethod
    def merge(cls, parts: Sequence["EngineStats"]) -> "EngineStats":
        """Aggregate engine snapshots into one.

        Counters and depths sum; ``mean_batch`` is dispatch-weighted; the
        percentiles are computed over the union of the parts' latency
        reservoirs. Parts without samples fall back to a completed-weighted
        average of their percentile fields.
        """
        parts = [p for p in parts if p is not None]
        if not parts:
            return cls(0, 0, 0, 0, 0, 0, 0.0, 0.0, 0.0)
        samples = sorted(s for p in parts for s in p.latency_samples)

        def _pct(q: float) -> float:
            if samples:
                return samples[min(int(q * len(samples)), len(samples) - 1)]
            field = "latency_ms_p50" if q == 0.50 else "latency_ms_p99"
            weights = [p.completed for p in parts]
            total = sum(weights) or len(parts)
            return sum(
                getattr(p, field) * (w if sum(weights) else 1)
                for p, w in zip(parts, weights)
            ) / total

        dispatches = sum(p.dispatches for p in parts)
        mean_batch = (
            sum(p.mean_batch * p.dispatches for p in parts) / dispatches
            if dispatches
            else 0.0
        )
        return cls(
            submitted=sum(p.submitted for p in parts),
            completed=sum(p.completed for p in parts),
            dispatches=dispatches,
            queue_depth=sum(p.queue_depth for p in parts),
            inflight_depth=sum(p.inflight_depth for p in parts),
            deadline_misses=sum(p.deadline_misses for p in parts),
            mean_batch=mean_batch,
            latency_ms_p50=_pct(0.50),
            latency_ms_p99=_pct(0.99),
            failed=sum(p.failed for p in parts),
            retries=sum(p.retries for p in parts),
            fallbacks=sum(p.fallbacks for p in parts),
            carry_resets=sum(p.carry_resets for p in parts),
            shed=sum(p.shed for p in parts),
            watchdog_trips=sum(p.watchdog_trips for p in parts),
            restores=sum(p.restores for p in parts),
            reconnects=sum(p.reconnects for p in parts),
            latency_samples=tuple(samples),
        )


@dataclasses.dataclass
class AsyncFrameRequest:
    """One queued frame. ``deadline`` is absolute ``time.monotonic`` seconds;
    ``stream_id`` is set only in video (packer) mode."""

    uid: int
    frame: object
    future: Future
    t_submit: float
    deadline: Optional[float] = None
    stream_id: Optional[Hashable] = None


@dataclasses.dataclass
class _InFlight:
    """A launched batch on its way to the completion thread."""

    batch: List[AsyncFrameRequest]
    outs: List[torch.Tensor]
    guard: DispatchGuard
    out_ok: Optional[torch.Tensor]  # host copies of the guard flags
    carry_ok: Optional[torch.Tensor]
    event: Optional["torch.cuda.Event"]  # None on the CPU: already done
    staging: torch.Tensor  # the pinned host buffer, alive until completion
    frames: torch.Tensor  # the batch on the plan's device (for a redispatch)
    rung: int = 0  # the fallback-ladder rung that dispatched it
    didx: Optional[int] = None  # the fault injector's dispatch index


class AsyncFrameEngine:
    """Background micro-batching denoise engine with per-request futures.

    Pass ``packer=`` (video mode: the packer's plan dispatches), ``plan=``
    (a :class:`repro_torch.plan.BGPlan` that quantizes its output), or
    ``cfg=`` and optionally ``device=`` and ``mesh=`` for the fused plan
    (``stream_input=True``: the ``"fused_streamed"`` plan; ``mesh=None``
    meshes over every card when the caller wants the card and more than one
    is visible); like the JAX engine it builds a plain ``BGPlan``, not
    ``plan_for``'s. A bf16 plan or
    a packer on one serves like any other: the pinned staging stays float32,
    as the frames arrive, and the plan casts to bf16 on the card.

    ``fault_injector`` (assignable at runtime), ``watchdog_ms`` (``None``:
    no watchdog), ``retry_policy``, ``fallback`` and ``admission_checks``
    wire the reliability layer (module docstring).
    """

    def __init__(
        self,
        cfg: BGConfig | None = None,
        max_batch: int = 32,
        max_queue: int = 256,
        batch_window_ms: float = 2.0,
        deadline_margin_ms: float = 1.0,
        max_inflight: int = 2,
        stream_input: bool = False,
        packer=None,
        plan=None,
        device=None,
        mesh=None,
        fault_injector=None,
        watchdog_ms: Optional[float] = None,
        retry_policy: Optional[RetryPolicy] = None,
        fallback: bool = True,
        admission_checks: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if watchdog_ms is not None and watchdog_ms <= 0:
            raise ValueError(f"watchdog_ms must be > 0 or None, got {watchdog_ms}")
        if (packer is not None or plan is not None) and (
            device is not None or stream_input or mesh is not None
        ):
            raise ValueError(
                "pass device=, mesh= and stream_input= with cfg=; a plan carries "
                "its own device, mesh and backend"
            )
        if packer is not None:
            # video mode dispatches through the packer's own plan
            if plan is not None and plan is not packer.plan:
                raise ValueError(
                    "pass either plan= or packer= (video mode dispatches "
                    "the packer's plan); got two different plans"
                )
            plan = packer.plan
        elif plan is None:
            if cfg is None:
                raise TypeError("AsyncFrameEngine needs cfg=, plan= or packer=")
            from repro_torch.plan import BGPlan
            from repro_torch.sharding.bg_shard import _service_mesh

            backend = "fused_streamed" if stream_input else "fused"
            plan = BGPlan(cfg=cfg, backend=backend, quantize_output=True, device=device,
                          mesh=_service_mesh(mesh, device))
        if not plan.quantize_output:
            raise ValueError(
                "AsyncFrameEngine serves quantized frames; build the plan "
                "with quantize_output=True"
            )
        self.plan = plan
        self.cfg = cfg if cfg is not None else plan.cfg
        self.max_batch = max_batch
        self.batch_window = batch_window_ms / 1e3
        self.deadline_margin = deadline_margin_ms / 1e3
        self.packer = packer
        self._packer_lock = threading.Lock()
        self.admission_checks = admission_checks
        self._launches: Dict[str, int] = {}  # this engine's threads' launches

        # reliability wiring (module docstring)
        self.fault_injector = fault_injector
        self.watchdog = None if watchdog_ms is None else watchdog_ms / 1e3
        ladder = plan.fallback_ladder() if fallback else (plan,)
        self._guard = GuardedDispatch(
            ladder, retry_policy, on_retry=self._count_retry, on_fallback=self._count_fallback
        )

        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max_inflight)
        self._held: Deque[AsyncFrameRequest] = deque()  # deferred same-stream
        self._uid = itertools.count()
        self._closed = False
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._outstanding = 0
        self._drained = threading.Condition(self._lock)
        # telemetry
        self._latencies: Deque[float] = deque(maxlen=4096)
        self._batch_sizes: Deque[int] = deque(maxlen=4096)
        self._dispatches = 0
        self._completed = 0
        self._submitted = 0
        self._deadline_misses = 0
        self._failed = 0
        self._retries = 0
        self._fallbacks = 0
        self._carry_resets = 0
        self._shed = 0
        self._watchdog_trips = 0

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="bg-frame-dispatch", daemon=True
        )
        self._completer = threading.Thread(
            target=self._complete_loop, name="bg-frame-complete", daemon=True
        )
        self._dispatcher.start()
        self._completer.start()

    # ------------------------------------------------------------- clients
    def submit(
        self,
        frame,
        stream_id: Optional[Hashable] = None,
        deadline_ms: Optional[float] = None,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> Future:
        """Queue one (h, w) frame; returns a Future resolving to the
        denoised frame, a tensor on the plan's device.

        Blocks when ``max_queue`` requests are already pending
        (``block=False`` raises ``queue.Full`` instead). ``deadline_ms`` is
        a latency budget from now; an expiring deadline forces its
        micro-batch out early, and a deadline that has already passed by
        collect time sheds the request with ``DeadlineExceeded``. Raises
        ``AdmissionError`` (a ``ValueError``) for malformed or non-finite
        frames.
        """
        if self.packer is not None and stream_id is None:
            raise ValueError("video mode: submit needs a stream_id")
        if self.admission_checks:
            frame = validate_frame(frame, stream_id=stream_id)
        inj = self.fault_injector
        if inj is not None:
            # post-admission hook: in-flight corruption admission cannot see
            frame = inj.corrupt_frame(frame, stream_id)
        now = time.monotonic()
        req = AsyncFrameRequest(
            uid=next(self._uid),
            frame=frame,
            future=Future(),
            t_submit=now,
            deadline=None if deadline_ms is None else now + deadline_ms / 1e3,
            stream_id=stream_id,
        )
        with self._lock:
            # atomic with close()'s flag: no request slips in behind shutdown
            if self._closed:
                raise EngineClosed("engine is closed")
            self._outstanding += 1
            self._submitted += 1
        try:
            self._queue.put(req, block=block, timeout=timeout)
        except queue.Full:
            with self._lock:
                self._outstanding -= 1
                self._submitted -= 1
            raise
        return req.future

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted frame has resolved. True on success."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._drained:
            while self._outstanding:
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._drained.wait(timeout=left)
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Drain outstanding work, then stop both threads (within
        ``timeout``; the threads are daemons). Requests still queued at stop
        fail with ``EngineClosed``, so no future is left pending."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.flush(timeout=timeout)
        self._stop.set()
        try:
            self._queue.put_nowait(_SENTINEL)
        except queue.Full:
            pass  # the dispatch loop's 100 ms poll notices _stop
        self._dispatcher.join(timeout=timeout)
        self._completer.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- telemetry
    def stats(self) -> EngineStats:
        def _pct(lat, q):
            return lat[min(int(q * len(lat)), len(lat) - 1)] * 1e3 if lat else 0.0

        with self._lock:
            lat = sorted(self._latencies)
            sizes = list(self._batch_sizes)
            return EngineStats(
                submitted=self._submitted,
                completed=self._completed,
                dispatches=self._dispatches,
                queue_depth=self._queue.qsize(),
                inflight_depth=self._inflight.qsize(),
                deadline_misses=self._deadline_misses,
                mean_batch=(sum(sizes) / len(sizes)) if sizes else 0.0,
                latency_ms_p50=_pct(lat, 0.50),
                latency_ms_p99=_pct(lat, 0.99),
                failed=self._failed,
                retries=self._retries,
                fallbacks=self._fallbacks,
                carry_resets=self._carry_resets,
                shed=self._shed,
                watchdog_trips=self._watchdog_trips,
                restores=getattr(self.packer, "carry_restores", 0) or 0,
                latency_samples=tuple(x * 1e3 for x in lat),
            )

    def launches(self) -> Dict[str, int]:
        """Kernel launches made by this engine's dispatch and completion
        threads, by counter (``"bg_fused.temporal_launches"``, ...): the
        wrappers' process-wide counters split by engine."""
        return _wrap.read_tally(self._launches)

    def _count_retry(self) -> None:
        with self._lock:
            self._retries += 1

    def _count_fallback(self) -> None:
        with self._lock:
            self._fallbacks += 1

    # ------------------------------------------------------------ dispatch
    def _get_next(self, timeout: Optional[float]):
        """Next request: deferred same-stream holdovers first, then the queue."""
        if self._held:
            return self._held.popleft()
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _shed_expired(self, req: AsyncFrameRequest) -> bool:
        """A request whose deadline already passed fails with
        ``DeadlineExceeded`` instead of being dispatched past its SLA."""
        if req.deadline is None:
            return False
        now = time.monotonic()
        if now <= req.deadline:
            return False
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(DeadlineExceeded(req.uid, late_s=now - req.deadline))
        with self._lock:
            self._shed += 1
            self._deadline_misses += 1
            self._outstanding -= 1
            self._drained.notify_all()
        return True

    def _drain_on_stop(self) -> None:
        """Fail whatever is still queued or held at shutdown."""
        leftovers: List[AsyncFrameRequest] = list(self._held)
        self._held.clear()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _SENTINEL:
                continue
            leftovers.append(item)
        if leftovers:
            self._finish(leftovers, error=EngineClosed("engine closed before dispatch"))

    def _collect_batch(self) -> Optional[List[AsyncFrameRequest]]:
        """Block for the first request, then fill until batch-full, window
        expiry, or an imminent request deadline. Sheds already-expired
        requests. Returns None on shutdown."""
        while True:
            first = self._get_next(timeout=0.1)
            if first is None:
                if self._stop.is_set():
                    self._drain_on_stop()
                    return None
                return []
            if first is _SENTINEL:
                self._drain_on_stop()
                return None
            if self._shed_expired(first):
                continue
            break
        batch = [first]
        streams = {first.stream_id}
        deferred: List[AsyncFrameRequest] = []
        target = self.max_batch
        if self.packer is not None:
            # one frame per stream per pack: never wait out the window for
            # frames that could only be same-stream repeats
            target = max(1, min(target, self.packer.live()))
        t_out = time.monotonic() + self.batch_window
        if first.deadline is not None:
            t_out = min(t_out, first.deadline - self.deadline_margin)
        while len(batch) < target:
            left = t_out - time.monotonic()
            if left <= 0:
                break
            nxt = self._get_next(timeout=left)
            if nxt is None:
                break
            if nxt is _SENTINEL:
                try:  # re-arm shutdown for the next loop
                    self._queue.put_nowait(_SENTINEL)
                except queue.Full:
                    self._stop.set()
                break
            if self._shed_expired(nxt):
                continue
            if self.packer is not None and nxt.stream_id in streams:
                deferred.append(nxt)  # one frame per stream per pack
                continue
            batch.append(nxt)
            streams.add(nxt.stream_id)
            if nxt.deadline is not None:
                t_out = min(t_out, nxt.deadline - self.deadline_margin)
        # back to the FRONT, in order: a deferred frame popped from the held
        # queue is older than any frame of its stream still held behind it
        self._held.extendleft(reversed(deferred))
        return batch

    def _stage(self, batch: List[AsyncFrameRequest]):
        """Stack one micro-batch into a (pinned) host buffer and copy it to
        the plan's device without blocking; once per batch, whatever rung
        then dispatches it. Returns ``(staging, frames on the device)``; for
        a mesh plan the frames are the staging itself, from which each shard
        is copied to its own device."""
        shapes = {tuple(np.shape(r.frame)) for r in batch}
        if len(shapes) != 1 or len(next(iter(shapes))) != 2:
            raise ValueError(f"a micro-batch needs equal (h, w) frames, got {sorted(shapes)}")
        dev = self.plan.device
        on_card = dev.type == "cuda"
        staging = torch.empty(
            (len(batch),) + next(iter(shapes)), dtype=torch.float32, pin_memory=on_card
        )
        for i, r in enumerate(batch):
            staging[i].copy_(torch.as_tensor(r.frame))
        if not on_card or self.plan.mesh is not None:
            return staging, staging
        return staging, staging.to(dev, non_blocking=True)

    def _launch_with(self, plan, batch: List[AsyncFrameRequest], staging, x) -> _InFlight:
        """Dispatch the staged batch ``x`` through ``plan`` (a fallback
        ladder rung) and record the event the completion wait is on."""
        if self.packer is not None:
            by_sid = {r.stream_id: x[i] for i, r in enumerate(batch)}
            with self._packer_lock:
                out, guard = self.packer.pack_guarded(
                    by_sid, plan=None if plan is self.plan else plan
                )
            outs = [out[r.stream_id] for r in batch]
        else:
            out = plan(x)
            guard = DispatchGuard(out_ok=finite_rows(out))
            outs = [out[i] for i in range(len(batch))]
        out_ok = None if guard.out_ok is None else guard.out_ok.to("cpu", non_blocking=True)
        carry_ok = None if guard.carry_ok is None else guard.carry_ok.to("cpu", non_blocking=True)
        event = None
        if plan.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(plan.device))
        return _InFlight(batch, outs, guard, out_ok, carry_ok, event, staging, x)

    def _guarded_launch(self, batch: List[AsyncFrameRequest]) -> _InFlight:
        """One guarded dispatch: retries, the fallback ladder and the
        breakers around :meth:`_launch_with`."""
        staging, x = self._stage(batch)
        box = {}

        def attempt(plan):
            inj = self.fault_injector
            box["didx"] = inj.on_dispatch(plan.backend) if inj else None
            return self._launch_with(plan, batch, staging, x)

        item, rung = self._guard.call(attempt)
        item.rung, item.didx = rung, box.get("didx")
        return item

    def _dispatch_loop(self):
        _wrap.tally_launches(self._launches)
        if self.plan.device.type == "cuda":
            torch.cuda.set_device(self.plan.device)
        while True:
            batch = self._collect_batch()
            if batch is None:  # shutdown: propagate downstream
                try:
                    self._inflight.put(_SENTINEL, timeout=1.0)
                except queue.Full:
                    pass  # completer wedged; it is a daemon
                return
            if not batch:
                continue
            try:
                item = self._guarded_launch(batch)
            except Exception as exc:  # caller errors, kernel errors, an exhausted ladder
                self._finish(batch, error=exc)
                continue
            with self._lock:
                self._dispatches += 1
                self._batch_sizes.append(len(batch))
            # backpressure: at most max_inflight launched batches downstream
            while True:
                try:
                    self._inflight.put(item, timeout=0.2)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        self._finish(batch, error=EngineClosed("engine closed mid-flight"))
                        break

    # ---------------------------------------------------------- completion
    def _await(self, item: _InFlight, didx: Optional[int], with_hook: bool = True) -> None:
        """Wait for ``item``'s dispatch to complete, bounded by the watchdog.

        The fault injector's completion hook (an injected hang) and the wait
        on the batch's CUDA event run inside the bounded region; past
        ``watchdog_ms`` both look alike: ``EngineTimeout`` and one watchdog
        trip. The helper thread of a wait that timed out is a daemon and
        ends when its event does (never, for a kernel truly hung on the
        card: the host cannot cancel it)."""

        def work():
            inj = self.fault_injector if with_hook else None
            if inj is not None:
                inj.on_complete(didx)
            if item.event is not None:
                try:
                    item.event.synchronize()
                except RuntimeError as exc:  # a CUDA error of the batch's kernels
                    raise KernelLaunchError(f"the dispatch's completion failed: {exc}") from exc

        if self.watchdog is None:
            work()
            return
        box = {}

        def runner():
            try:
                work()
            except BaseException as exc:  # raised on the waiting side
                box["err"] = exc

        t = threading.Thread(target=runner, name="bg-frame-await", daemon=True)
        t.start()
        t.join(self.watchdog)
        if t.is_alive():
            with self._lock:
                self._watchdog_trips += 1
            raise EngineTimeout(self.watchdog, uids=[r.uid for r in item.batch])
        if "err" in box:
            raise box["err"]

    def _quarantine(self, sids) -> None:
        """Reset the given streams' temporal carries to cold, counting
        actual resets."""
        if self.packer is None or not sids:
            return
        n = 0
        with self._packer_lock:
            for sid in sids:
                n += self.packer.quarantine(sid)
        if n:
            with self._lock:
                self._carry_resets += n

    def _resolve(self, item: _InFlight, didx: Optional[int] = None) -> None:
        """Post-completion guard pass and future resolution for one batch;
        then the injector's carry faults for dispatch ``didx``."""
        guard = item.guard
        if item.carry_ok is not None and guard.carry_sids:
            flags = item.carry_ok.numpy()
            self._quarantine([s for s, ok in zip(guard.carry_sids, flags) if not ok])
        errors = None
        if item.out_ok is not None:
            flags = item.out_ok.numpy()
            pos = None if guard.order is None else {s: i for i, s in enumerate(guard.order)}
            errors = [
                None
                if bool(flags[j if pos is None else pos[req.stream_id]])
                else NonFiniteOutput(req.uid, stream_id=req.stream_id)
                for j, req in enumerate(item.batch)
            ]
            if not any(e is not None for e in errors):
                errors = None
        # injected carry corruption or loss lands after a healthy completion:
        # the poison the next pack's guard flags must catch. It lands before
        # the futures resolve (the JAX engine's order is the reverse), so a
        # client that waits for a pack before sending the next always sees it.
        inj = self.fault_injector
        if inj is not None and self.packer is not None and didx is not None:
            with self._packer_lock:
                inj.apply_carry_faults(self.packer.sessions, didx)
        self._finish(item.batch, outs=item.outs, errors=errors)

    def _on_completion_failure(self, item: _InFlight, exc: Exception) -> None:
        """A launched batch failed to complete (a CUDA error, a watchdog
        trip, an injected fault). Charges the dispatching rung's breaker. A
        video pack is stateful: its futures fail, and its streams' carries
        are quarantined, only those whose carry flags read bad when the
        flags can still be read without the hook (none for a pure hang),
        else every warm stream of the pack. A stateless batch gets one
        synchronous guarded redispatch (retries, the ladder, the watchdog)
        of its staged frames, so a transient completion failure still
        serves results; unless the failure was a CUDA error
        (``KernelLaunchError``), which fails its futures as it is."""
        self._guard.record_remote_failure(item.rung)
        batch = item.batch
        if self.packer is not None:
            suspects = list(item.guard.carry_sids)
            if suspects and item.carry_ok is not None:
                try:
                    self._await(item, None, with_hook=False)
                    flags = item.carry_ok.numpy()
                    suspects = [s for s, ok in zip(item.guard.carry_sids, flags) if not ok]
                except Exception:
                    pass  # flags unreadable: quarantine the whole pack
            self._quarantine(suspects)
            self._finish(batch, error=exc)
            return
        if isinstance(exc, (KernelBuildError, KernelLaunchError)):
            self._finish(batch, error=exc)
            return
        try:

            def attempt(plan):
                inj = self.fault_injector
                didx = inj.on_dispatch(plan.backend) if inj else None
                again = self._launch_with(plan, batch, item.staging, item.frames)
                self._await(again, didx)
                return again

            again, _ = self._guard.call(attempt)
        except Exception as exc2:
            self._finish(batch, error=exc2)
            return
        self._resolve(again)

    def _finish(self, batch, outs=None, error=None, errors=None):
        now = time.monotonic()
        # resolve futures BEFORE announcing completion: flush() returning
        # implies every future is done; a client-cancelled future is skipped
        per_req = errors if errors is not None else [error] * len(batch)
        for i, req in enumerate(batch):
            if not req.future.set_running_or_notify_cancel():
                continue
            if per_req[i] is not None:
                req.future.set_exception(per_req[i])
            else:
                req.future.set_result(outs[i])
        with self._lock:
            for i, req in enumerate(batch):
                self._latencies.append(now - req.t_submit)
                if req.deadline is not None and now > req.deadline:
                    self._deadline_misses += 1
                self._completed += per_req[i] is None
                self._failed += per_req[i] is not None
            self._outstanding -= len(batch)
            self._drained.notify_all()

    def _complete_loop(self):
        _wrap.tally_launches(self._launches)  # a stateless redispatch launches here
        while True:
            try:
                item = self._inflight.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set() and not self._dispatcher.is_alive():
                    return
                continue
            if item is _SENTINEL:
                return
            try:
                self._await(item, item.didx)
            except Exception as exc:
                self._on_completion_failure(item, exc)
                continue
            self._resolve(item, didx=item.didx)
