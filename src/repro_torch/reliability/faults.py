"""Deterministic, seedable fault injection for the serving stack: the port of
``repro/reliability/faults.py``.

A :class:`FaultPlan` is a frozen schedule of :class:`Fault` entries, and a
:class:`FaultInjector` is the mutable runtime that fires them at the
engine's hook points. Everything is keyed on deterministic counters
(per-stream frame index, global dispatch index) and a seeded numpy RNG, the
JAX package's own (``np.random.default_rng(seed)``), so a plan with the same
seed corrupts the same pixels in both packages and a chaos test replays bit
for bit.

Hook points (all on the host; no device work but a carry overwrite):

  ``corrupt_frame(frame, stream_id)``   called by ``AsyncFrameEngine.submit``
      after admission validation: simulates in-flight corruption the
      admission guard cannot see. Fires ``corrupt_frame`` faults: NaN/Inf
      into a seeded-random subset of the pixels.
  ``on_dispatch(backend)``              called inside each guarded dispatch
      attempt (and by :meth:`FaultInjector.plan_hook` for every
      ``BGPlan.__call__``). Fires ``raise_dispatch`` faults by raising
      :class:`~repro_torch.reliability.errors.InjectedFault`; returns the
      dispatch index otherwise.
  ``on_complete(dispatch)``             called inside the watchdog-bounded
      completion wait, before the wait on the dispatch's CUDA event. Fires
      ``hang_completion`` faults by sleeping ``delay_s``: a long delay trips
      the engine watchdog as a wedged device would.
  ``apply_carry_faults(sessions, dispatch)``  called by the engine after a
      pack completes. Fires ``corrupt_carry`` (overwrite a stream's carry
      with NaN/Inf, on its device) and ``drop_carry`` (lose it): the poison
      the carry quarantine must catch on the next pack.

The transport kinds (``drop_message``, ``truncate_message``,
``delay_heartbeat``) validate as in the JAX package, so the two packages
accept the same plans; their hook, ``on_transport``, belongs to the fleet's
socket workers and is not ported yet.

Fault matching: a fault fires when every non-``None`` selector matches
(``stream_id``, ``frame_index``, ``dispatch``, ``backend``) and it has fired
fewer than ``times`` times (``times=None``: unlimited). ``backend`` lets a
test fail one rung of the fallback ladder while the others serve.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from .errors import InjectedFault

__all__ = ["Fault", "FaultPlan", "FaultInjector", "FAULT_KINDS"]

FAULT_KINDS = (
    "corrupt_frame",
    "corrupt_carry",
    "drop_carry",
    "raise_dispatch",
    "hang_completion",
    # transport kinds: fired by the fleet's socket transport (not ported yet)
    "drop_message",
    "truncate_message",
    "delay_heartbeat",
)
_MODES = ("nan", "inf")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``None`` selectors match anything.

    Fields:
      kind:        one of :data:`FAULT_KINDS`.
      stream_id:   restrict frame and carry faults to one stream.
      frame_index: restrict ``corrupt_frame`` to the n-th submitted frame of
                   its stream (per-injector counter, 0-based).
      dispatch:    restrict dispatch, completion and carry faults to the
                   n-th dispatch attempt seen by this injector (0-based).
      backend:     restrict ``raise_dispatch`` to one ``BGPlan.backend``:
                   the lever for failing one rung of the fallback ladder.
      mode:        corruption value, ``"nan"`` or ``"inf"``.
      fraction:    fraction of pixels ``corrupt_frame`` corrupts (for
                   ``truncate_message``, the fraction of a message kept).
      delay_s:     the sleep of ``hang_completion`` (for
                   ``delay_heartbeat``, the suppression window).
      times:       the most times it fires (``None``: every match fires).
      message:     restrict transport faults to one wire message type.
    """

    kind: str
    stream_id: Optional[Hashable] = None
    frame_index: Optional[int] = None
    dispatch: Optional[int] = None
    backend: Optional[str] = None
    mode: str = "nan"
    fraction: float = 0.05
    delay_s: float = 0.0
    times: Optional[int] = 1
    message: Optional[str] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")
        if self.delay_s < 0.0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1 or None, got {self.times}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A frozen, replayable fault schedule: the faults plus the RNG seed
    that fixes which pixels ``corrupt_frame`` hits."""

    faults: Tuple[Fault, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))
        for f in self.faults:
            if not isinstance(f, Fault):
                raise TypeError(f"FaultPlan takes Fault entries, got {f!r}")


class FaultInjector:
    """Runtime for one :class:`FaultPlan`: counters, seeded RNG, fire log.

    Thread-safe: the engine's client, dispatch and completion threads all
    call into it. ``fired`` holds each fault's fire count and ``log`` the
    ``(event, detail)`` tuples, for tests and benches.
    """

    def __init__(self, plan):
        if not isinstance(plan, FaultPlan):
            plan = FaultPlan(faults=tuple(plan))
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self._lock = threading.Lock()
        self.fired: List[int] = [0] * len(plan.faults)
        self.log: List[Tuple[str, object]] = []
        self._frame_counts: Dict[Hashable, int] = {}
        self._dispatches = 0

    # ------------------------------------------------------------ matching
    def _armed(self, i: int) -> bool:
        t = self.plan.faults[i].times
        return t is None or self.fired[i] < t

    def _corrupt_values(self, arr: np.ndarray, fault: Fault) -> np.ndarray:
        """Seeded NaN/Inf splat over ``fraction`` of the pixels (the JAX
        package's draw, so the same seed hits the same pixels)."""
        out = np.array(arr, np.float32, copy=True)
        k = max(1, int(round(fault.fraction * out.size)))
        pos = self._rng.choice(out.size, size=k, replace=False)
        out.reshape(-1)[pos] = np.nan if fault.mode == "nan" else np.inf
        return out

    # ---------------------------------------------------------- hook points
    def corrupt_frame(self, frame, stream_id: Hashable = None):
        """Maybe-corrupted copy of ``frame`` (the post-admission submit hook);
        a corrupted frame comes back as a float32 numpy array."""
        with self._lock:
            idx = self._frame_counts.get(stream_id, 0)
            self._frame_counts[stream_id] = idx + 1
            for i, f in enumerate(self.plan.faults):
                if f.kind != "corrupt_frame" or not self._armed(i):
                    continue
                if f.stream_id is not None and f.stream_id != stream_id:
                    continue
                if f.frame_index is not None and f.frame_index != idx:
                    continue
                frame = self._corrupt_values(np.asarray(frame), f)
                self.fired[i] += 1
                self.log.append(("corrupt_frame", (stream_id, idx)))
            return frame

    def on_dispatch(self, backend: Optional[str] = None) -> int:
        """Count one dispatch attempt; raise if a ``raise_dispatch`` fault
        matches. Returns the attempt's dispatch index."""
        with self._lock:
            d = self._dispatches
            self._dispatches += 1
            for i, f in enumerate(self.plan.faults):
                if f.kind != "raise_dispatch" or not self._armed(i):
                    continue
                if f.dispatch is not None and f.dispatch != d:
                    continue
                if f.backend is not None and f.backend != backend:
                    continue
                self.fired[i] += 1
                self.log.append(("raise_dispatch", (d, backend)))
                raise InjectedFault(
                    f"injected dispatch fault at dispatch {d} (backend {backend!r})",
                    dispatch=d,
                )
            return d

    def on_complete(self, dispatch: Optional[int] = None) -> None:
        """Completion hook: sleep for any matching ``hang_completion`` fault
        (run inside the engine watchdog's bounded wait)."""
        delay = 0.0
        with self._lock:
            for i, f in enumerate(self.plan.faults):
                if f.kind != "hang_completion" or not self._armed(i):
                    continue
                if f.dispatch is not None and dispatch is not None and f.dispatch != dispatch:
                    continue
                self.fired[i] += 1
                delay += f.delay_s
                self.log.append(("hang_completion", (dispatch, f.delay_s)))
        if delay > 0.0:
            time.sleep(delay)

    def apply_carry_faults(self, sessions, dispatch: Optional[int] = None):
        """Corrupt or drop matching streams' temporal carries in place.

        ``sessions`` is the packer's ``{sid: StreamSession}`` map; call under
        the engine's packer lock. Returns the stream ids mutated.
        """
        hit = []
        with self._lock:
            for i, f in enumerate(self.plan.faults):
                if f.kind not in ("corrupt_carry", "drop_carry"):
                    continue
                if f.dispatch is not None and dispatch is not None and f.dispatch != dispatch:
                    continue
                for sid, sess in sessions.items():
                    if not self._armed(i):
                        break
                    if f.stream_id is not None and f.stream_id != sid:
                        continue
                    if sess.carry is None:
                        continue
                    if f.kind == "drop_carry":
                        sess.carry = None
                    else:
                        val = float("nan") if f.mode == "nan" else float("inf")
                        sess.carry = torch.full_like(sess.carry, val)
                    self.fired[i] += 1
                    hit.append(sid)
                    self.log.append((f.kind, (sid, dispatch)))
        return hit

    # ----------------------------------------------------- plan integration
    @contextlib.contextmanager
    def plan_hook(self):
        """Install this injector as the global ``repro_torch.plan`` dispatch
        hook: every ``BGPlan.__call__`` in the process runs ``on_dispatch``
        first. The engine does not need it (it calls ``on_dispatch`` inside
        its guarded attempts); it is for other callers of plans."""
        from repro_torch.plan import set_dispatch_hook

        prev = set_dispatch_hook(lambda plan: self.on_dispatch(plan.backend))
        try:
            yield self
        finally:
            set_dispatch_hook(prev)
