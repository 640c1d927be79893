"""The port's own spans and counters, recorded only while a ``torch.profiler``
session is active.

A span is a named stretch of one thread's host time; spans nest, and each
record keeps the index of the span that encloses it on its thread (-1 for a
root), so every span of one dispatch leads to that dispatch's root. A
layer's self time is its span less the time its children cover. A counter
is an instant record (start equal to end) whose value is the count, so a
count carries its time and its parent too. A root span's value is the frames
or streams it carries.

Times are ``time.perf_counter_ns()``: the clock a profiler trace is moved
onto to set device ops beside host spans, so the two compare with no
conversion.

Recording is on only between a profiler session's start and stop
(``torch.autograd.profiler._is_profiler_enabled``). Off, a span point reads
that flag, returns a shared no-op object and allocates nothing. Records go
into one bounded buffer in memory: ``CAPACITY`` records, about 120 bytes each;
those that do not fit are counted by :func:`dropped`. :func:`records` copies
the buffer out and :func:`clear` empties it.

The names the port records (each is read by a benchmark metric):

  ``packer.pack`` (root, value: streams)
                        ``video/session.py::MultiStreamPacker.pack_guarded``
  ``engine.step`` (root, value: frames)
                        ``serving/frames.py::FrameDenoiseEngine.step``
  ``kernel.<wrapper>``  one kernel launch: ``bg_fused``, ``bg_create``,
                        ``bg_blur``, ``bg_slice``
  ``wait.<site>``       the host blocked on the card (:func:`wait`,
                        :func:`as_frames`), with one ``sync`` count inside
  ``build`` (counter)   a kernel library compiled or loaded, a plan
                        executable or plan variant built (a cache miss)
  ``plan.cast``         one storage cast of a fused route under bf16
                        (``plan.py::_cast``), with one ``cast`` count inside
"""
from __future__ import annotations

import array
import operator
import threading
import time
from typing import List, NamedTuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["CAPACITY", "Record", "span", "wait", "count", "as_frames", "records",
           "dropped", "clear"]

# records the buffer holds: a 51 s window of 1,500 dispatches a second at 2
# records a dispatch is 153,000
CAPACITY = 1 << 20

_now = time.perf_counter_ns
_lock = threading.Lock()
# the buffer: each record's (start, parent, value, name id), and its
# end apart, the one field written after; replaced, not emptied, by clear(),
# so a span open across it writes its end into the old buffer
_recs: list = []
_ends = array.array("q")
_names: List[str] = []
_ids: dict = {}
_dropped = 0


class _Thread(threading.local):
    """Each thread's open spans (their indices, innermost last)."""

    def __init__(self):
        self.stack = []


_thread = _Thread()


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int  # -1 while the span is open; equal to start for a counter
    parent: int  # index of the enclosing span on the same thread, -1 for a root
    value: int


def _name_id(name: str) -> int:
    nid = _ids.get(name)
    if nid is None:
        with _lock:
            nid = _ids.setdefault(name, len(_names))
            if nid == len(_names):
                _names.append(name)
    return nid


def _record(stack: list, start: int, end: int, value: int, nid: int):
    """Append one record under the innermost span open on ``stack`` (the
    calling thread's); ``(ends, index)``, the index -1 when the buffer is
    full."""
    global _dropped
    parent = stack[-1] if stack else -1
    _lock.acquire()
    recs, ends = _recs, _ends
    index = len(recs)
    if index < CAPACITY:
        if parent >= index:  # a span opened before clear() encloses nothing after it
            parent = -1
        recs.append((start, parent, value, nid))
        ends.append(end)
    else:
        _dropped += 1
        index = -1
    _lock.release()
    return ends, index


class _Off:
    """The span of a point while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    """One open span, made by :func:`span` and :func:`wait`."""

    __slots__ = ("nid", "value", "sync", "stack", "ends", "index")

    def __init__(self, nid: int, value: int, sync: bool):
        self.nid, self.value, self.sync = nid, value, sync

    def __enter__(self):
        self.stack = stack = _thread.stack
        self.ends, self.index = _record(stack, _now(), -1, self.value, self.nid)
        stack.append(self.index)
        if self.sync:
            count("sync")
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.index >= 0:
            self.ends[self.index] = _now()
        self.stack.pop()
        return False


def span(name: str, value: int = 0):
    """``with span(name):`` records the block as a span named ``name``;
    ``value`` is a root's frames or streams."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(_ids[name] if name in _ids else _name_id(name), value, False)


def wait(site: str, device):
    """``with wait(site, device):`` around a call that blocks the host on the
    card: a blocking copy from the host to ``device``, which synchronizes the
    stream. A span ``wait.<site>`` with one ``sync`` count in it; on the CPU
    (``device`` not a card) the span alone, as nothing waits there."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(_name_id("wait." + site), 0, device is not None and device.type == "cuda")


def count(name: str, n: int = 1) -> None:
    """An instant record of ``n`` under the innermost open span."""
    if not _profiler._is_profiler_enabled:
        return
    t = _now()
    _record(_thread.stack, t, t, n, _ids[name] if name in _ids else _name_id(name))


def as_frames(frames: list, device, site: str) -> list:
    """``[torch.as_tensor(f, dtype=torch.float32, device=device) for f in
    frames]``. A host frame bound for a card is a blocking copy, which waits
    for the card's queue: while recording, a conversion that copied host
    frames is a span ``wait.<site>`` with one ``sync`` count a host frame.
    A card frame comes back as itself (or converted on the card), so the
    common case costs one identity pass."""
    if not (_profiler._is_profiler_enabled and device is not None and device.type == "cuda"):
        return [torch.as_tensor(f, dtype=torch.float32, device=device) for f in frames]
    start = _now()
    out = [torch.as_tensor(f, dtype=torch.float32, device=device) for f in frames]
    if any(map(operator.is_not, out, frames)):
        host = sum(not (isinstance(f, torch.Tensor) and f.is_cuda) for f in frames)
        if host:
            stack = _thread.stack
            _, index = _record(stack, start, _now(), 0, _name_id("wait." + site))
            stack.append(index)  # the sync count's parent
            count("sync", host)
            stack.pop()
    return out


def records() -> List[Record]:
    """A copy of every record, in the order they were opened."""
    with _lock:
        recs, ends, names = list(_recs), _ends.tolist(), list(_names)
    return [Record(names[nid], start, end, parent, value)
            for (start, parent, value, nid), end in zip(recs, ends)]


def dropped() -> int:
    """Records refused since the last :func:`clear` because the buffer was full."""
    return _dropped


def clear() -> None:
    """Empty the buffer and the drop count (the table of names stays)."""
    global _recs, _ends, _dropped
    with _lock:
        _recs, _ends = [], array.array("q")
        _dropped = 0
