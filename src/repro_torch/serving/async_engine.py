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

Guards: ``submit`` validates shape, dtype and finiteness on the host
(``AdmissionError``). Each dispatch launches per-row ``isfinite`` flags over
its outputs (and, in video mode, the advanced carries), read at completion:
a non-finite output row fails exactly that request with
``NonFiniteOutput``, a bad carry row quarantines exactly that stream. A
dispatch error fails that batch's futures and nothing else; the engine
keeps serving. There is no retry, fallback ladder, watchdog or fault
injection yet: no path here gives way to another backend.

Telemetry: ``stats()`` returns an :class:`EngineStats` snapshot.
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
from repro_torch.reliability import (
    DeadlineExceeded,
    DispatchGuard,
    EngineClosed,
    NonFiniteOutput,
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
    failures, finite-guard rejections); ``carry_resets``: temporal carries
    quarantined back to cold; ``shed``: requests dropped at collect time
    because their deadline had passed; ``restores``: carries installed from
    a snapshot. ``latency_samples`` carries the sorted latency reservoir
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
    carry_resets: int = 0
    shed: int = 0
    restores: int = 0
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
            carry_resets=sum(p.carry_resets for p in parts),
            shed=sum(p.shed for p in parts),
            restores=sum(p.restores for p in parts),
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


class AsyncFrameEngine:
    """Background micro-batching denoise engine with per-request futures.

    Pass ``packer=`` (video mode: the packer's plan dispatches), ``plan=``
    (a :class:`repro_torch.plan.BGPlan` that quantizes its output), or
    ``cfg=`` and optionally ``device=`` for the fused plan
    (``stream_input=True``: the ``"fused_streamed"`` plan). A bf16 plan or
    a packer on one serves like any other: the pinned staging stays float32,
    as the frames arrive, and the plan casts to bf16 on the card.
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
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if (packer is not None or plan is not None) and (device is not None or stream_input):
            raise ValueError(
                "pass device= and stream_input= with cfg=; a plan carries its "
                "own device and backend"
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

            backend = "fused_streamed" if stream_input else "fused"
            plan = BGPlan(cfg=cfg, backend=backend, quantize_output=True, device=device)
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
        self._carry_resets = 0
        self._shed = 0

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
        frame = validate_frame(frame, stream_id=stream_id)
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
                carry_resets=self._carry_resets,
                shed=self._shed,
                restores=getattr(self.packer, "carry_restores", 0) or 0,
                latency_samples=tuple(x * 1e3 for x in lat),
            )

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

    def _launch(self, batch: List[AsyncFrameRequest]) -> _InFlight:
        """Stack one micro-batch into a (pinned) host buffer, copy it to the
        plan's device without blocking, dispatch it, and record the event
        the completion thread waits on."""
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
        x = staging.to(dev, non_blocking=True) if on_card else staging
        if self.packer is not None:
            by_sid = {r.stream_id: x[i] for i, r in enumerate(batch)}
            with self._packer_lock:
                out, guard = self.packer.pack_guarded(by_sid)
            outs = [out[r.stream_id] for r in batch]
        else:
            out = self.plan(x)
            guard = DispatchGuard(out_ok=finite_rows(out))
            outs = [out[i] for i in range(len(batch))]
        out_ok = None if guard.out_ok is None else guard.out_ok.to("cpu", non_blocking=True)
        carry_ok = None if guard.carry_ok is None else guard.carry_ok.to("cpu", non_blocking=True)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return _InFlight(batch, outs, guard, out_ok, carry_ok, event, staging)

    def _dispatch_loop(self):
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
                item = self._launch(batch)
            except Exception as exc:  # fails this batch, nothing else
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

    def _resolve(self, item: _InFlight) -> None:
        """Post-completion guard pass and future resolution for one batch."""
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
        self._finish(item.batch, outs=item.outs, errors=errors)

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
                if item.event is not None:
                    item.event.synchronize()
            except Exception as exc:
                # the card failed this batch: its advanced carries are suspect
                self._quarantine(list(item.guard.carry_sids))
                self._finish(item.batch, error=exc)
                continue
            self._resolve(item)
