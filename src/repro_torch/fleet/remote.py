"""Process-isolated fleet worker: the parent-side transport (the port of
``repro/fleet/remote.py``).

:class:`SubprocessWorker` implements the
:class:`~repro_torch.fleet.worker.Worker` protocol across a process
boundary. The router sees the same narrow surface as :class:`LocalWorker`;
underneath, every call crosses a Unix-domain (or localhost TCP) socket as a
length-prefixed :mod:`repro_torch.fleet.codec` message, and the actual
``AsyncFrameEngine`` lives in a child process spawned as ``python -m
repro_torch.fleet.remote_worker`` (a fresh interpreter: never a fork of a
process that may hold a CUDA context). A segfault, OOM, or wedged dispatch
kills *one worker process*; the router's failover machinery (watchdog ->
``fail_worker`` -> re-pin) handles the rest.

Topology and lifecycle::

    parent (router process)                    child (worker process)
    ─────────────────────────                  ──────────────────────
    bind UDS, listen, spawn ──────────────────▶ connect, HELLO
    PLAN {controller payload, config, device} ▶ rebuild BGPlan, host one
                                                AsyncFrameEngine, load the
    ◀─────────────────────── READY {plan_hash}  port's kernel libraries
    SUBMIT {rid, sid, geometry} + frame ──────▶ engine.submit
    ◀──────────── RESULT/ERROR {rid} + frame    (result thread)
    ◀──────────── HEARTBEAT {queue depth}       every interval
    ◀──────────── SNAPSHOT {sid} + carry        every interval (warm)
    CALL {rid, op} ───────────────────────────▶ control RPC
    ◀──────────────────────────── ACK {rid}

Robustness contract:

* **Liveness** is three independent signals: ``proc.poll()`` (a SIGKILLed
  child is seen immediately), heartbeat freshness (a *wedged* child, alive
  but not serving, goes unhealthy after ``heartbeat_timeout_s``), and the
  reader thread's connection state. ``healthy() is False`` is what the
  ``FleetWatchdog`` polls, so detection feeds the failover path unchanged.
* **No request can hang.** Every submit is tracked in a parent-side
  pending table; a sweep thread fails overdue entries (``submit_timeout_s``,
  covering silently dropped messages) and fails *everything* the moment
  the child process exits or the connection tears, always with structured
  :class:`WorkerDown`, never a dangling Future. Sync RPCs carry their own
  hard timeout. Torn/corrupt wire data is a :class:`CodecError` at the
  codec layer; the connection is reset and in-flight work failed.
* **Reconnect** is child-driven with bounded backoff: a poisoned
  connection (e.g. an injected truncation desynchronizing the framing)
  tears down, the child re-dials the same listener, and the parent
  re-handshakes, counted in ``reconnects``. A dead *process* does not
  reconnect; that is worker death and the router replaces the worker
  (``FleetRouter.replace_worker``).
* **Warm-carry snapshots**: the child periodically ships every warm
  stream's ``(sid, carry, alpha, frames_seen)`` over the snapshot channel,
  the carry in the plan's storage type (bf16 as its 2-byte words); the
  parent stores the latest complete snapshot per stream, stamped with the
  *parent's* monotonic clock on receipt. ``carry_snapshot(sid)`` reads this
  store: it keeps answering after the child is gone, which is what lets
  ``fail_worker`` restore a SIGKILLed worker's streams onto survivors
  instead of cold-quarantining them. A snapshot truncated mid-transfer by
  the crash never decodes, so the store retains the previous complete one
  (all-or-nothing per stream, by construction).

Deliberate asymmetries vs :class:`LocalWorker` (documented, not bugs):
``queue_depth()`` counts parent-side unresolved submits (instantaneous, no
RPC; a superset of the child's undispatched backlog, so router backpressure
sheds slightly earlier, never later). ``fault_injector=`` here is the
*transport* injector (``drop_message``/``truncate_message``/
``delay_heartbeat`` fault points, applied parent-side so seeding stays
single-process deterministic); engine-level fault hooks stay a LocalWorker
feature. Stream ids must be JSON-plain (``str``/``int``) to travel the
wire. Results come back as host arrays (numpy, as they cross the wire),
where a :class:`LocalWorker`'s futures hold tensors on the plan's device.

Port notes: ``device=`` (a string: ``"cuda"``, the default, or ``"cpu"``)
goes to the child in the PLAN message, beside the JAX worker's
``mesh="auto"``, the only mesh taken here, as there: the child binds the
payload's ``mesh_size`` over its host's first cards (``BGPlan.from_json``)
and answers ERROR when it has fewer; a child asked for the card on a host
without one answers ERROR and exits 1, it never serves on the CPU. The child loads the port's
kernel libraries (building them with nvcc if the checkout has no build)
before READY, so ``start_timeout_s`` covers the build and no sweep timer
runs during it. A send, or a read mid-message, tears on either side only
after it has made no progress for ``heartbeat_timeout_s`` (the child takes
the limit from the PLAN message), where the JAX transport's 0.5 s socket
timeout tears it at once: a full-HD frame is 8.3 MB. :meth:`launches`
reads the child's kernel launch counters and :meth:`wire` its result
thread's seconds over the stats RPC.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import queue
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, Hashable, List, Optional

import numpy as np

from repro_torch.reliability import EngineClosed
from repro_torch.serving import EngineStats

from . import codec
from .errors import CodecError, ConnectionClosed, PlanMismatch, WorkerDown
from .worker import CarrySnapshot, Worker

__all__ = ["SubprocessWorker"]

# child ERROR/ACK etype -> parent exception class. Unknown types map to
# RuntimeError: transient-looking failures should hit the router's health
# breakers (retry/evacuate-on-repeat), not masquerade as caller bugs.
_ETYPE_MAP = {
    "KeyError": KeyError,
    "ValueError": ValueError,
    "TypeError": TypeError,
    "Full": queue.Full,
    "EngineClosed": EngineClosed,
    "WorkerDown": None,  # special-cased: needs wid
    "PlanMismatch": PlanMismatch,
}


def _map_error(wid, hdr: dict) -> Exception:
    etype = hdr.get("etype", "RuntimeError")
    detail = hdr.get("detail", "")
    if etype == "WorkerDown":
        return WorkerDown(wid, detail)
    cls = _ETYPE_MAP.get(etype)
    if cls is queue.Full:
        return queue.Full()
    if cls is not None:
        return cls(detail)
    return RuntimeError(f"worker {wid!r}: {etype}: {detail}")


@dataclasses.dataclass
class _Pending:
    fut: Future
    t: float
    kind: str  # "submit" | "call"
    sid: Optional[Hashable] = None


class SubprocessWorker(Worker):
    """One worker process behind the :class:`Worker` protocol (see the
    module docstring for the wire architecture and robustness contract)."""

    def __init__(
        self,
        wid,
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
        transport: str = "unix",
        heartbeat_interval_s: float = 0.25,
        heartbeat_timeout_s: float = 3.0,
        snapshot_interval_s: float = 0.25,
        rpc_timeout_s: float = 60.0,
        submit_timeout_s: float = 120.0,
        start_timeout_s: float = 180.0,
        reconnect_attempts: int = 5,
        reconnect_backoff_s: float = 0.05,
    ):
        if not isinstance(wid, (str, int)):
            raise TypeError(
                f"SubprocessWorker wid must be JSON-plain (str/int), "
                f"got {type(wid).__name__}"
            )
        if not (isinstance(mesh, str) and mesh == "auto"):
            raise ValueError(
                "SubprocessWorker resolves its mesh in the child process; "
                "only mesh='auto' is supported"
            )
        if transport not in ("unix", "tcp"):
            raise ValueError(f"transport must be 'unix' or 'tcp', got {transport!r}")
        self.wid = wid
        self._payload = payload
        self._hash = payload["plan_hash"]
        self._temporal = bool(payload["plan"]["temporal"])
        self.max_queue = max_queue
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.rpc_timeout_s = rpc_timeout_s
        self.submit_timeout_s = submit_timeout_s
        self._start_timeout_s = start_timeout_s
        self._faults = fault_injector
        self._child_config = {
            "payload": payload,
            "device": "cuda" if device is None else str(device),
            "worker_kwargs": {
                "max_batch": max_batch,
                "max_queue": max_queue,
                "batch_window_ms": batch_window_ms,
                "watchdog_ms": watchdog_ms,
                "engine_kwargs": engine_kwargs,
            },
            "heartbeat_interval_s": heartbeat_interval_s,
            "snapshot_interval_s": snapshot_interval_s,
            "heartbeat_timeout_s": heartbeat_timeout_s,
        }

        self._lock = threading.RLock()
        self._send_lock = threading.Lock()
        self._rid = itertools.count()
        self._pending: Dict[int, _Pending] = {}
        self._snapshots: Dict[Hashable, CarrySnapshot] = {}
        self.streams_served: Dict[Hashable, int] = {}
        self._conn: Optional[socket.socket] = None
        self._had_conn = False
        self._reconnects = 0
        self._last_hb = 0.0
        self._child_qd = 0
        self._killed = False
        self._closed = False
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._start_err: Optional[Exception] = None

        # ---- listener -------------------------------------------------
        self._tmpdir = tempfile.mkdtemp(prefix=f"bgfleet-{wid}-")
        if transport == "unix":
            path = os.path.join(self._tmpdir, "worker.sock")
            self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listener.bind(path)
            self._addr = f"unix:{path}"
        else:
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.bind(("127.0.0.1", 0))
            host, port = self._listener.getsockname()
            self._addr = f"tcp:{host}:{port}"
        self._listener.listen(2)
        self._listener.settimeout(0.2)

        # ---- child process --------------------------------------------
        env = dict(os.environ)
        import repro_torch

        src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        self._proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "repro_torch.fleet.remote_worker",
                "--wid", json.dumps(wid),
                "--connect", self._addr,
                "--reconnect-attempts", str(reconnect_attempts),
                "--reconnect-backoff-s", str(reconnect_backoff_s),
            ],
            env=env,
            stdin=subprocess.DEVNULL,
        )

        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"bgfleet-accept-{wid}", daemon=True
        )
        self._sweep_thread = threading.Thread(
            target=self._sweep_loop, name=f"bgfleet-sweep-{wid}", daemon=True
        )
        self._accept_thread.start()
        self._sweep_thread.start()

        # Block construction on the first handshake: a bad payload (plan
        # mismatch, no card where one is asked for) must fail the constructor with the
        # child's structured error, not surface later as a dead worker.
        if not self._ready.wait(start_timeout_s):
            self._teardown()
            raise WorkerDown(
                wid, f"worker process not ready after {start_timeout_s}s"
            )
        if self._start_err is not None:
            self._teardown()
            raise self._start_err

    # ------------------------------------------------------------ transport
    @property
    def fault_injector(self):
        """The transport fault injector — assignable mid-life, same pattern
        as ``AsyncFrameEngine.fault_injector`` (a soak warms up clean,
        installs an injector for the faulted phase, clears it to recover)."""
        return self._faults

    @fault_injector.setter
    def fault_injector(self, injector) -> None:
        self._faults = injector

    def _send(self, msg_type: str, header: dict, payload: bytes = b"",
              conn: Optional[socket.socket] = None) -> None:
        data = codec.encode(msg_type, header, payload)
        if self._faults is not None:
            data = self._faults.on_transport(msg_type, data, "send")
            if data is None:
                return  # injected drop: the bytes vanish; sweeps catch it
        with self._send_lock:
            c = conn if conn is not None else self._conn
            if c is None:
                raise WorkerDown(self.wid, "no transport connection")
            try:
                codec.send_all(c, data, self.heartbeat_timeout_s)
            except OSError as exc:
                raise WorkerDown(self.wid, f"send failed: {exc}") from None

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by teardown
            try:
                self._handshake(conn)
            except Exception as exc:
                if not self._ready.is_set():
                    self._start_err = (
                        exc if isinstance(exc, (PlanMismatch, WorkerDown))
                        else WorkerDown(self.wid, f"handshake failed: {exc}")
                    )
                    self._ready.set()
                try:
                    conn.close()
                except OSError:
                    pass

    def _handshake(self, conn: socket.socket) -> None:
        conn.settimeout(self._child_handshake_timeout())
        name, hdr, _ = codec.read_message(conn.recv)
        if name != "hello":
            raise CodecError(f"expected hello, got {name!r}")
        self._send("plan", self._child_config, conn=conn)
        name, hdr, _ = codec.read_message(conn.recv)
        if name == "error":
            raise _map_error(self.wid, hdr)
        if name != "ready":
            raise CodecError(f"expected ready, got {name!r}")
        if hdr.get("plan_hash") != self._hash:
            raise PlanMismatch(
                f"worker {self.wid!r}: child rebuilt plan hashes to "
                f"{hdr.get('plan_hash')!r}, controller payload claims "
                f"{self._hash!r}"
            )
        conn.settimeout(0.5)
        with self._lock:
            old, self._conn = self._conn, conn
            if self._had_conn:
                self._reconnects += 1
            self._had_conn = True
            self._last_hb = time.monotonic()
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        threading.Thread(
            target=self._reader_loop, args=(conn,),
            name=f"bgfleet-reader-{self.wid}", daemon=True,
        ).start()
        self._ready.set()

    def _child_handshake_timeout(self) -> float:
        # first connect includes the child's torch import, plan rebuild and
        # kernel load (an nvcc build when the checkout has none)
        return self._start_timeout_s if not self._had_conn else 30.0

    def _reader_loop(self, conn: socket.socket) -> None:
        while not self._stop.is_set():
            with self._lock:
                if self._conn is not conn:
                    return  # superseded by a reconnect
            try:
                name, hdr, payload = codec.read_message(conn.recv, self.heartbeat_timeout_s)
            except TimeoutError:
                continue  # idle at a message boundary
            except (ConnectionClosed, CodecError, OSError) as exc:
                self._drop_conn(conn, f"connection lost: {exc}")
                return
            try:
                self._handle(name, hdr, payload)
            except Exception:
                pass  # one bad message never kills the reader

    def _drop_conn(self, conn: socket.socket, reason: str) -> None:
        with self._lock:
            if self._conn is conn:
                self._conn = None
        try:
            conn.close()
        except OSError:
            pass
        self._fail_pending(WorkerDown(self.wid, reason))

    def _fail_pending(self, exc: Exception) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
        for p in pending.values():
            if not p.fut.done():
                p.fut.set_exception(exc)

    # -------------------------------------------------------- message pump
    def _handle(self, name: str, hdr: dict, payload: bytes) -> None:
        if name == "heartbeat":
            if self._faults is not None and (
                self._faults.on_transport("heartbeat", payload, "recv") is None
            ):
                return  # injected heartbeat suppression window
            with self._lock:
                self._last_hb = time.monotonic()
                self._child_qd = int(hdr.get("qd", 0))
            return
        if name == "snapshot":
            self._store_snapshot(hdr, payload)
            return
        if name in ("result", "error", "ack"):
            rid = hdr.get("rid")
            with self._lock:
                p = self._pending.pop(rid, None)
            if p is None or p.fut.done():
                return  # already timed out / failed over
            if name == "result":
                try:
                    p.fut.set_result(codec.decode_array(hdr, payload))
                except CodecError as exc:
                    p.fut.set_exception(
                        WorkerDown(self.wid, f"undecodable result: {exc}")
                    )
            elif name == "error":
                p.fut.set_exception(_map_error(self.wid, hdr))
            else:  # ack
                if hdr.get("ok", False):
                    p.fut.set_result(hdr.get("result"))
                else:
                    p.fut.set_exception(_map_error(self.wid, hdr))

    def _store_snapshot(self, hdr: dict, payload: bytes) -> None:
        # A snapshot only reaches here complete and CRC-clean (a transfer
        # torn by a crash never decodes), so the store always holds the
        # latest *complete* snapshot per stream — the all-or-nothing
        # property fail_worker's restore path relies on.
        try:
            carry = codec.decode_array(hdr, payload)
            snap = CarrySnapshot(
                sid=hdr["sid"],
                carry=carry,
                alpha=float(hdr["alpha"]),
                frames_seen=int(hdr["frames_seen"]),
                plan_hash=hdr["plan_hash"],
                taken_at=time.monotonic(),  # parent clock: skew-immune age
            )
        except (CodecError, KeyError, TypeError, ValueError):
            return  # malformed snapshot: keep the previous complete one
        with self._lock:
            self._snapshots[snap.sid] = snap

    # -------------------------------------------------------------- sweeps
    def _sweep_loop(self) -> None:
        while not self._stop.wait(0.1):
            now = time.monotonic()
            if self._proc.poll() is not None and not self._killed:
                self._fail_pending(WorkerDown(
                    self.wid,
                    f"worker process exited rc={self._proc.returncode}",
                ))
                continue
            overdue: List[_Pending] = []
            with self._lock:
                for rid in [
                    r for r, p in self._pending.items()
                    if p.kind == "submit" and now - p.t > self.submit_timeout_s
                ]:
                    overdue.append(self._pending.pop(rid))
            for p in overdue:
                if not p.fut.done():
                    p.fut.set_exception(WorkerDown(
                        self.wid,
                        f"submit unresolved after {self.submit_timeout_s}s "
                        f"(message lost?)",
                    ))

    # ------------------------------------------------------------ sync RPC
    def _rpc(self, msg_type: str, header: dict, payload: bytes = b"",
             timeout: Optional[float] = None):
        if self._killed:
            raise WorkerDown(self.wid, f"{msg_type} on a dead worker")
        rid = next(self._rid)
        fut: Future = Future()
        with self._lock:
            self._pending[rid] = _Pending(fut, time.monotonic(), "call")
        try:
            self._send(msg_type, {**header, "rid": rid}, payload)
        except WorkerDown:
            with self._lock:
                self._pending.pop(rid, None)
            raise
        try:
            return fut.result(timeout if timeout is not None
                              else self.rpc_timeout_s)
        except (TimeoutError, _FutureTimeout):  # distinct classes on py3.10
            with self._lock:
                self._pending.pop(rid, None)
            raise WorkerDown(
                self.wid, f"rpc {header.get('op', msg_type)!r} timed out"
            ) from None

    def _call(self, op: str, args: Optional[dict] = None,
              timeout: Optional[float] = None):
        return self._rpc("call", {"op": op, "args": args or {}},
                         timeout=timeout)

    # ---------------------------------------------------------------- plan
    @property
    def plan_hash(self) -> str:
        return self._hash

    @property
    def temporal(self) -> bool:
        return self._temporal

    # ------------------------------------------------------------- streams
    def open_stream(self, sid: Hashable, alpha: float = 0.0) -> None:
        if not isinstance(sid, (str, int)):
            raise TypeError(
                f"subprocess workers need JSON-plain stream ids (str/int), "
                f"got {type(sid).__name__}"
            )
        self._call("open_stream", {"sid": sid, "alpha": float(alpha)})

    def close_stream(self, sid: Hashable) -> None:
        self._call("close_stream", {"sid": sid})
        with self._lock:
            self._snapshots.pop(sid, None)

    def quarantine(self, sid: Hashable) -> bool:
        return bool(self._call("quarantine", {"sid": sid}))

    def warm_streams(self) -> List[Hashable]:
        return list(self._call("warm_streams"))

    # ----------------------------------------------------------- snapshots
    def carry_snapshot(self, sid: Hashable) -> Optional[CarrySnapshot]:
        """Latest complete snapshot shipped by the child — served from the
        parent-side store, so it keeps answering after the child dies
        (which is precisely when ``fail_worker`` asks)."""
        with self._lock:
            return self._snapshots.get(sid)

    def restore_carry(self, sid: Hashable, snap: CarrySnapshot) -> bool:
        if snap.plan_hash != self._hash:
            return False
        # dtype-preserving: a bf16 carry travels as bf16 bytes (the
        # codec names it; the child-side packer re-validates geometry)
        try:
            ok = self._rpc(
                "restore",
                {
                    "sid": sid,
                    "alpha": snap.alpha,
                    "frames_seen": snap.frames_seen,
                    "plan_hash": snap.plan_hash,
                    **codec.array_header(snap.carry),
                },
                codec.array_bytes(snap.carry),
            )
        except (WorkerDown, CodecError):
            return False
        if ok:
            with self._lock:
                # the restored carry is this worker's freshest known state
                self._snapshots[sid] = dataclasses.replace(
                    snap, taken_at=time.monotonic()
                )
        return bool(ok)

    def request_snapshot(self) -> List[Hashable]:
        """Ask the child to push a fresh snapshot of every warm stream
        *now* (they arrive before the ACK). Returns the snapshotted sids —
        the deterministic lever for tests and pre-planned restarts that
        cannot wait out ``snapshot_interval_s``."""
        sids = self._call("snapshot_now")
        deadline = time.monotonic() + self.rpc_timeout_s
        # the ACK races the snapshot messages through the same socket in
        # order, so by the time the ACK is handled they are stored; the
        # wait below is belt-and-braces for fault-injected drops
        while time.monotonic() < deadline:
            with self._lock:
                if all(s in self._snapshots for s in sids):
                    break
            time.sleep(0.005)
        return list(sids)

    # ------------------------------------------------------------- serving
    def submit(self, frame, stream_id=None, deadline_ms=None, block=True,
               timeout=None):
        if self._killed:
            raise WorkerDown(self.wid, "submit on a dead worker")
        arr = np.ascontiguousarray(np.asarray(frame))
        rid = next(self._rid)
        fut: Future = Future()
        with self._lock:
            depth = sum(1 for p in self._pending.values()
                        if p.kind == "submit")
            if depth >= self.max_queue:
                # the router's backpressure (max_worker_queue < max_queue)
                # sheds before this; reaching it means racing submitters
                raise queue.Full()
            self._pending[rid] = _Pending(
                fut, time.monotonic(), "submit", stream_id
            )
        hdr = {
            "rid": rid,
            "sid": stream_id,
            "deadline_ms": deadline_ms,
            "plan_hash": self._hash,
            **codec.array_header(arr),
        }
        try:
            self._send("submit", hdr, arr.tobytes())
        except WorkerDown:
            with self._lock:
                self._pending.pop(rid, None)
            raise
        if stream_id is not None:
            with self._lock:
                self.streams_served[stream_id] = (
                    self.streams_served.get(stream_id, 0) + 1
                )
        return fut

    def queue_depth(self) -> int:
        # parent-side unresolved submits: instantaneous (no RPC) and a
        # superset of the child's undispatched backlog, so the router's
        # backpressure fires no later than it would for a LocalWorker
        with self._lock:
            return sum(1 for p in self._pending.values()
                       if p.kind == "submit")

    def stats(self) -> EngineStats:
        d = dict(self._call("stats"))
        d["latency_samples"] = tuple(d.get("latency_samples") or ())
        # extra header fields (the child's launch counters) are not stats
        fields = {f.name for f in dataclasses.fields(EngineStats)}
        st = EngineStats(**{k: v for k, v in d.items() if k in fields})
        return dataclasses.replace(st, reconnects=self._reconnects)

    def launches(self) -> Dict[str, int]:
        """The child's kernel launch counters, read over the stats RPC
        (the child hosts one engine, so its process counters are the
        worker's)."""
        counts = self._call("stats").get("launches") or {}
        return {k: v for k, v in counts.items() if v}

    def wire(self) -> Dict[str, float]:
        """The child's result thread, over the stats RPC: ``results`` sent,
        ``copy_s`` spent copying them to the host and ``send_s`` encoding
        and sending them."""
        return dict(self._call("stats").get("wire") or {})

    def flush(self, timeout: Optional[float] = None) -> bool:
        rpc_timeout = None if timeout is None else timeout + 5.0
        ok = bool(self._call("flush", {"timeout": timeout},
                             timeout=rpc_timeout))
        # the child drained; give in-flight RESULT messages a moment to
        # cross back so the parent pending table drains too
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.rpc_timeout_s)
        while self.queue_depth() and time.monotonic() < deadline:
            time.sleep(0.005)
        return ok and self.queue_depth() == 0

    # -------------------------------------------------------------- health
    @property
    def reconnects(self) -> int:
        return self._reconnects

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    def healthy(self) -> bool:
        with self._lock:
            if self._killed or self._closed:
                return False
            stale = time.monotonic() - self._last_hb > self.heartbeat_timeout_s
        if self._proc.poll() is not None:
            return False  # SIGKILL/exit: seen immediately, no timeout wait
        return not stale

    def crash(self) -> None:
        """SIGKILL the child *without* telling the parent-side state — the
        unannounced-death chaos hook (the rolling-restart soak's hammer).
        Liveness machinery must notice on its own: ``proc.poll()`` flips
        ``healthy()`` immediately and the sweep fails in-flight work."""
        try:
            os.kill(self._proc.pid, signal.SIGKILL)
        except (OSError, ProcessLookupError):
            pass

    def kill(self) -> None:
        """Abrupt stop (the router's ``fail_worker`` path): SIGKILL the
        child, fail every in-flight Future structurally, stop serving."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
        self.crash()
        self._fail_pending(WorkerDown(self.wid, "worker killed"))
        with self._lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if not self._killed and self._proc.poll() is None:
            try:
                self.flush(timeout=timeout)
            except Exception:
                pass
            try:
                self._send("shutdown", {"timeout": min(timeout, 10.0)})
                self._proc.wait(timeout=min(timeout, 10.0))
            except Exception:
                pass
        self._teardown()

    def _teardown(self) -> None:
        self._stop.set()
        if self._proc.poll() is None:
            self._proc.kill()
            try:
                self._proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        self._fail_pending(WorkerDown(self.wid, "worker closed"))
        for sock in (self._conn, self._listener):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        self._conn = None
        shutil.rmtree(self._tmpdir, ignore_errors=True)

    def __repr__(self):
        return (
            f"SubprocessWorker(wid={self.wid!r}, pid={self._proc.pid}, "
            f"plan_hash={self._hash!r}, healthy={self.healthy()})"
        )
