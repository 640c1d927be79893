"""The program's own spans and counters (``repro_torch.tracing``) in a traced
run's window, for the readers of ``program_span`` metrics.

The program records only while a profiler session is active, so a traced
run (whose ``Tracer`` holds one over the window) leaves its records in the
program's buffer. They are on ``time.perf_counter_ns()``, the clock the
trace's device ops are moved onto, so a root span's interval and the device
ops inside it compare with no conversion. Each record names the span that
encloses it, so every record leads to a root: a pack (``packer.pack``) or a
dispatch (``engine.step``).

Every function returns ``None`` where the run has no trace, the program has
no tracer (a commit before it), the window holds no records (or no root of
the name asked for), or the buffer dropped records.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from .stats import gaps

__all__ = ["Program", "program", "wait_ms", "work_ms", "syncs_per_root", "kernel_host_us",
           "idle_ms", "builds"]


def _snapshot():
    """``(records, dropped)`` of the program's tracer, or ``None`` without one."""
    try:
        tracing = importlib.import_module("repro_torch.tracing")
    except ImportError:
        return None
    if not hasattr(tracing, "records"):
        return None
    return tracing.records(), tracing.dropped()


@dataclasses.dataclass
class Program:
    """The window's records on the ``perf_counter`` clock, in seconds."""

    roots: Dict[str, List[Tuple[float, float]]]  # root name -> (start, end) of each root
    waits: Dict[str, List[float]]  # root name -> summed ``wait.*`` seconds of each root
    syncs: Dict[str, List[int]]  # root name -> ``sync`` counts of each root
    kernels: List[float]  # seconds of every ``kernel.*`` span
    builds: int  # ``build`` counts


def program(run) -> Optional[Program]:
    """The program's records inside ``run.trace.lo`` to ``hi``, once per run."""
    if getattr(run, "trace", None) is None:
        return None
    if "_program" in vars(run):
        return vars(run)["_program"]
    view = None
    snap = _snapshot()
    if snap is not None and snap[1] == 0:
        view = _window(snap[0], run.trace.lo, run.trace.hi)
    vars(run)["_program"] = view
    return view


def _window(records, lo: float, hi: float) -> Optional[Program]:
    lo_ns, hi_ns = lo * 1e9, hi * 1e9
    root_of: List[int] = []
    for i, r in enumerate(records):  # a parent is recorded before its children
        root_of.append(i if r.parent < 0 else root_of[r.parent])
    inside = [lo_ns <= r.start_ns and 0 <= r.end_ns <= hi_ns for r in records]
    if not any(inside):
        return None
    slot: Dict[int, Tuple[str, int]] = {}  # root record -> (its name, its place in the lists)
    roots: Dict[str, list] = {}
    waits: Dict[str, list] = {}
    syncs: Dict[str, list] = {}
    kernels: List[float] = []
    n_builds = 0
    for i, r in enumerate(records):
        if not inside[i]:
            continue
        if r.parent < 0 and r.end_ns > r.start_ns:
            slot[i] = (r.name, len(roots.setdefault(r.name, [])))
            roots[r.name].append((r.start_ns / 1e9, r.end_ns / 1e9))
            waits.setdefault(r.name, []).append(0.0)
            syncs.setdefault(r.name, []).append(0)
    for i, r in enumerate(records):
        if not inside[i]:
            continue
        if r.name.startswith("kernel."):
            kernels.append((r.end_ns - r.start_ns) / 1e9)
        elif r.name == "build":
            n_builds += r.value
        root = slot.get(root_of[i])
        if root is None or i == root_of[i]:
            continue
        if r.name.startswith("wait."):
            waits[root[0]][root[1]] += (r.end_ns - r.start_ns) / 1e9
        elif r.name == "sync":
            syncs[root[0]][root[1]] += r.value
    return Program(roots, waits, syncs, kernels, n_builds)


def _roots(run, root: str):
    view = program(run)
    if view is None or not view.roots.get(root):
        return None
    return view


def wait_ms(run, root: str) -> Optional[float]:
    """The mean, over the roots named ``root``, of their summed ``wait.*`` ms."""
    view = _roots(run, root)
    if view is None:
        return None
    return 1e3 * sum(view.waits[root]) / len(view.waits[root])


def work_ms(run, root: str) -> Optional[float]:
    """The mean, over the roots named ``root``, of their ms less their ``wait.*`` ms."""
    view = _roots(run, root)
    if view is None:
        return None
    spans = view.roots[root]
    return 1e3 * (sum(b - a for a, b in spans) - sum(view.waits[root])) / len(spans)


def syncs_per_root(run, root: str) -> Optional[float]:
    """``sync`` counts (the host blocked on the card) per root named ``root``."""
    view = _roots(run, root)
    if view is None:
        return None
    return sum(view.syncs[root]) / len(view.syncs[root])


def kernel_host_us(run) -> Optional[float]:
    """The mean host us of a ``kernel.*`` span: one launch's checks and call."""
    view = program(run)
    if view is None or not view.kernels:
        return None
    return 1e6 * sum(view.kernels) / len(view.kernels)


def idle_ms(run, root: str) -> Optional[float]:
    """The mean, over the roots named ``root``, of the ms inside each root's
    interval in which the device ran no op (kernel, copy, memset) of the
    trace."""
    view = _roots(run, root)
    if view is None or not run.trace.ops:
        return None
    holes = gaps(((a, b) for _, a, b in run.trace.ops), run.trace.lo, run.trace.hi)
    starts = [a for a, _ in holes]
    before = [0.0]  # idle seconds before each hole
    for a, b in holes:
        before.append(before[-1] + (b - a))

    def idle_until(t: float) -> float:
        k = bisect.bisect_right(starts, t) - 1
        if k < 0:
            return 0.0
        a, b = holes[k]
        return before[k] + min(t, b) - a

    spans = view.roots[root]
    return 1e3 * sum(idle_until(b) - idle_until(a) for a, b in spans) / len(spans)


def builds(run) -> Optional[int]:
    """``build`` counts in the window: kernels compiled or loaded, plan
    executables or variants built."""
    view = program(run)
    return None if view is None else view.builds
