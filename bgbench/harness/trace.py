"""The traced run: ``torch.profiler`` over the whole measured window, reduced
to the device's operations (kernels, copies, memsets) on the host's clock.

Only device activity is recorded (no per-op host events), so the profiler
costs the host little: CUPTI's record of each launch. The profiler stamps
events in nanoseconds since the epoch; they are moved onto
``time.perf_counter`` by the offset between the two clocks, read when the
trace starts, so the harness's own host spans can name what the host was
doing in each idle gap of the device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import torch

from .stats import gaps, union_length

__all__ = ["Tracer", "TraceSummary"]


@dataclasses.dataclass
class TraceSummary:
    lo: float  # the traced window on the host's perf_counter clock
    hi: float
    ops: List[Tuple[str, float, float]]  # (name, start, end) of every device op in it

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_length(((a, b) for _, a, b in self.ops), self.lo, self.hi)

    def op_seconds(self, needle: str = "") -> float:
        """Summed durations of the ops whose name contains ``needle``."""
        return sum(b - a for name, a, b in self.ops if needle in name)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: Dict[str, List[Tuple[float, float]]], n: int = 10) -> List[list]:
        """The ``n`` longest stretches with no device op, each named by the
        harness span that covers its middle (``host`` where none does)."""
        holes = sorted(gaps(((a, b) for _, a, b in self.ops), self.lo, self.hi),
                       key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in holes:
            mid = 0.5 * (a + b)
            label = "host"
            for name, ivs in spans.items():
                if any(s <= mid <= e for s, e in ivs):
                    label = name
                    break
            out.append([label, b - a])
        return out


class Tracer:
    """``start()`` and ``stop()`` around the window; ``warm()`` in set-up,
    so that the profiler's own first start (CUPTI's) is not in the window."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self._lo = 0.0

    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA] if self.device.type == "cuda" else [ProfilerActivity.CPU]

    def warm(self) -> None:
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1.0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import profile

        self._prof = profile(activities=self._activities())
        self._prof.start()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self._lo = time.perf_counter()

    def stop(self) -> TraceSummary:
        """Call after the device has finished the window's work."""
        hi = time.perf_counter()
        self._prof.stop()
        ops = []
        if self.device.type == "cuda":
            from torch.autograd import DeviceType

            for e in self._prof.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                    continue
                a = (e.start_ns() - self._offset_ns) / 1e9
                ops.append((e.name(), a, a + e.duration_ns() / 1e9))
        self._prof = None
        return TraceSummary(self._lo, hi, ops)
