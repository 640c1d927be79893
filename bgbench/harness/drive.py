"""The one traffic generator: it reads a mix's parameters and drives the
entry point the mix names (``traffic/<mix>.json``'s ``entry``) with frames
from the card's pool.

An entry point is a file of its own, ``entries/<entry>.py``, found by
name as a metric's reader is. It holds the loop that feeds the program
(``drive``) and the comparison of what that loop produced (``check``):

  ``drive(run, pool, seed, seconds, device, precision, tracer, t_start)``
      builds the program's objects, warms up the cell's own shapes, sets
      ``run.setup_s`` where the first timed dispatch starts, runs the
      window for ``seconds``, closes it when the last of its work has
      completed, fills ``run`` and returns what ``check`` needs;
  ``check(run, ref, pool, state)`` returns the ``Verdict`` of the sampled
      outputs against the configuration's reference.

This module keeps what every entry shares: the pool, the tracer, the peak
memory, the clocks (``Stamps``, ``Done``, ``wait_until``) and the record of
a run (``Run``). After the window the peak memory is read, the program's
objects are dropped, and the comparison runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from .check import Verdict
from .frames import make_pool
from .trace import TraceSummary, Tracer

__all__ = ["Run", "Stamps", "Done", "wait_until", "sync", "bg_config", "drive"]


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers. The entry point sets
    ``temporal`` (whether a frame's step carries a temporal grid) and
    records one span per dispatch under its own name."""

    config: dict
    traffic: dict
    temporal: bool = False
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    completed: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    lateness_ms: List[float] = dataclasses.field(default_factory=list)
    packs: List[Tuple[float, float]] = dataclasses.field(default_factory=list)  # (due, done)
    spans: Dict[str, List[Tuple[float, float]]] = dataclasses.field(default_factory=dict)
    trace: Optional[TraceSummary] = None
    memory_peak_bytes: int = 0
    plan: str = ""
    verdict: Optional[Verdict] = None
    check_s: float = 0.0

    def span(self, name: str, a: float, b: float) -> None:
        self.spans.setdefault(name, []).append((a, b))


def wait_until(due: float) -> None:
    """Sleep to just before ``due``, then spin to it: ``time.sleep`` alone
    wakes up to a millisecond late."""
    left = due - time.perf_counter()
    if left > 0.002:
        time.sleep(left - 0.0015)
    while time.perf_counter() < due:
        pass


class Stamps:
    """When marked points of the device's queue completed, on the host's
    ``perf_counter`` clock. On a card each mark is a timing event, placed on
    the host's clock by two anchors, events recorded on an idle device at
    the start and at the end beside a host reading (which also corrects the
    two clocks' drift), so no host thread's scheduling delays a stamp. On
    the CPU the work is done when the call returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []
        if self.cuda:
            torch.cuda.synchronize(device)
            self.e0, self.h0 = self._anchor()

    @staticmethod
    def _anchor():
        ev = torch.cuda.Event(enable_timing=True)
        a = time.perf_counter()
        ev.record()
        return ev, 0.5 * (a + time.perf_counter())

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def times(self) -> List[float]:
        """Every mark's completion time; waits for the device."""
        if not self.cuda:
            return list(self.marks)
        torch.cuda.synchronize()
        e1, h1 = self._anchor()
        torch.cuda.synchronize()
        span = self.e0.elapsed_time(e1) / 1e3
        scale = (h1 - self.h0) / span if span > 0 else 1.0
        return [self.h0 + scale * self.e0.elapsed_time(ev) / 1e3 for ev in self.marks]


class Done:
    """Completion of the work queued so far: a CUDA event on a card; on the
    CPU the work is done when the call returns."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bg_config(cfg: dict):
    """The program's ``BGConfig`` for a configuration file's numbers."""
    from repro_torch.core.bilateral_grid import BGConfig

    return BGConfig(r=int(cfg["r"]), sigma_s=float(cfg["sigma_s"]), sigma_r=float(cfg["sigma_r"]),
                    intensity_max=float(cfg["intensity_max"]),
                    normalize_mode=cfg["normalize_mode"], weight_mode=cfg["weight_mode"])


def drive(spec, seed: int, seconds: float, traced: bool, device: torch.device, t_start: float,
          precision: Optional[str] = None, check: bool = True) -> Run:
    """One run of the cell ``spec``. ``precision`` is passed to ``plan_for``
    as it is (``None``: the program's default, fp32). ``check=False`` skips
    the comparison (the knee sweep's runs)."""
    cfg, tr = spec.config, spec.traffic
    run = Run(config=cfg, traffic=tr)
    entry = spec.entry()
    ref = spec.reference()
    h, w = int(cfg["height"]), int(cfg["width"])
    pool = make_pool(seed, int(tr["pool_frames"]), h, w, scenes=int(tr["scenes"]),
                     motion_px=float(tr["motion_px"]),
                     noise_sigma=float(cfg["assumed"]["noise_sigma"]), device=device)
    tracer = None
    if traced:
        tracer = Tracer(device)
        tracer.warm()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = entry.drive(run, pool, seed, seconds, device, precision, tracer, t_start)
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
        torch.cuda.empty_cache()
    if not check:
        return run
    t = time.perf_counter()
    run.verdict = entry.check(run, ref, pool, state)
    run.check_s = time.perf_counter() - t
    return run
