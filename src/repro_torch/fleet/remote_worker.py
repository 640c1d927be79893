"""Worker-process entrypoint: ``python -m repro_torch.fleet.remote_worker``
(the port of ``repro/fleet/remote_worker.py``).

The child half of :mod:`repro_torch.fleet.remote`. It dials the parent's
listener, introduces itself (HELLO), receives the controller payload +
engine configuration + device (PLAN), rebuilds the :class:`BGPlan` by
constructing a :class:`~repro_torch.fleet.worker.LocalWorker` on that
device (reusing its plan-hash verification, so a tampered payload dies
here with a structured ``PlanMismatch`` ERROR, never a half-built worker),
loads the port's kernel libraries (an nvcc build when the checkout has
none), answers READY, and then serves the message loop. One process hosts
exactly one ``AsyncFrameEngine``. A PLAN for the card on a host without one
is an ERROR and exit code 1: the child never serves on the CPU in its place.

Four threads run per connection:

* the **serve loop** (main thread): SUBMIT frames into the engine
  (``block=False``: the reader never wedges on a full queue; the parent
  gets a structured ``Full`` ERROR), answers CALL control RPCs, applies
  RESTOREs, honors SHUTDOWN.
* the **result thread**: each engine future, when done, is queued to it;
  it copies the result to the host (a CUDA tensor's ``.cpu()``) and sends
  RESULT/ERROR, off the engine's completion thread. The seconds it spends
  on the copies and on the sends are in the stats reply.
* the **heartbeat thread**: liveness + queue depth every interval. It also
  watches for orphanhood (``os.getppid() == 1``) and exits the process:
  a worker whose router died must not linger.
* the **snapshot thread**: every interval, ships each warm stream's carry
  (in the plan's storage type) to the parent's snapshot store. A SIGKILL
  mid-``sendall`` tears the message; the parent's codec rejects the torn
  frame and keeps the previous complete snapshot (the all-or-nothing
  transfer property).

Connection loss (torn frames from injected truncation, a parent-side
reset) tears down the socket and re-dials with bounded exponential backoff
mirroring :class:`repro_torch.reliability.RetryPolicy`: the *worker state*
(engine, packer, carries) survives reconnects; only the transport is
rebuilt. Exhausted attempts or a vanished parent end the process: a child
that cannot reach its router serves nobody.

The stats reply carries the child's kernel launch counters
(``"launches"``) and its result-path seconds (``"wire"``) beside the
engine's stats, as extra header fields the protocol tolerates.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import socket
import sys
import threading
import time
from typing import Optional

from . import codec
from .errors import CodecError, ConnectionClosed
from .worker import CarrySnapshot

__all__ = ["main"]


def _etype(exc: Exception) -> dict:
    return {"etype": type(exc).__name__, "detail": str(exc)}


class _Conn:
    """One live socket + its send lock (serve loop, heartbeat, snapshot,
    and engine completion callbacks all write; frames must not interleave)."""

    def __init__(self, sock: socket.socket, stall_s: float = 3.0):
        self.sock = sock
        # a send or read making no progress this long tears: the parent's
        # heartbeat_timeout_s, past which it counts this child as down
        self.stall_s = stall_s
        self._lock = threading.Lock()
        self.broken = False

    def send(self, msg_type: str, header: dict, payload: bytes = b"") -> None:
        data = codec.encode(msg_type, header, payload)
        with self._lock:
            if self.broken:
                raise ConnectionClosed("connection marked broken")
            try:
                codec.send_all(self.sock, data, self.stall_s)
            except OSError:
                self.broken = True
                raise

    def close(self) -> None:
        self.broken = True
        try:
            self.sock.close()
        except OSError:
            pass


def _dial(addr: str, attempts: int, backoff_s: float) -> socket.socket:
    """Connect with RetryPolicy-shaped bounded exponential backoff."""
    kind, _, rest = addr.partition(":")
    delay = backoff_s
    last: Optional[Exception] = None
    for i in range(max(1, attempts)):
        try:
            if kind == "unix":
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.connect(rest)
            elif kind == "tcp":
                host, _, port = rest.rpartition(":")
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                sock.connect((host, int(port)))
            else:
                raise ValueError(f"unknown transport in address {addr!r}")
            return sock
        except OSError as exc:
            last = exc
            if i + 1 < attempts:
                time.sleep(min(delay, 1.0))
                delay *= 2.0
    raise ConnectionRefusedError(
        f"could not reach router at {addr!r} after {attempts} attempts: {last}"
    )


def _heartbeat_loop(conn: _Conn, worker, interval_s: float,
                    stop: threading.Event) -> None:
    while not stop.wait(interval_s):
        if os.getppid() == 1:
            os._exit(0)  # orphaned: the router process is gone
        try:
            conn.send("heartbeat", {
                "qd": worker.queue_depth(), "t": time.time(),
            })
        except (ConnectionClosed, OSError):
            return


def _push_snapshots(conn: _Conn, worker) -> list:
    sids = []
    for sid in worker.warm_streams():
        snap = worker.carry_snapshot(sid)
        if snap is None:
            continue
        conn.send(  # the storage type's bytes: bf16 ships 2 per value
            "snapshot",
            {
                "sid": sid,
                "alpha": snap.alpha,
                "frames_seen": snap.frames_seen,
                "plan_hash": snap.plan_hash,
                **codec.array_header(snap.carry),
            },
            codec.array_bytes(snap.carry),
        )
        sids.append(sid)
    return sids


def _snapshot_loop(conn: _Conn, worker, interval_s: float,
                   stop: threading.Event) -> None:
    while not stop.wait(interval_s):
        try:
            _push_snapshots(conn, worker)
        except (ConnectionClosed, OSError):
            return
        except Exception:
            continue  # a transient read race never kills the channel


class _Results:
    """The result thread: sends each done future's RESULT or ERROR, its
    result copied to the host here, off the engine's completion thread
    (a full-HD fp32 frame is 8.3 MB). Counts its seconds for the stats."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self.copy_s = 0.0  # device-to-host copies of results
        self.send_s = 0.0  # encoding and sending them
        self.sent = 0
        threading.Thread(target=self._loop, name="bgfleet-results", daemon=True).start()

    def put(self, conn: "_Conn", rid, fut) -> None:
        self._queue.put((conn, rid, fut))

    def drain(self, timeout: float) -> None:
        """Wait (bounded) until every queued result has been sent."""
        end = time.monotonic() + timeout
        while self._queue.unfinished_tasks and time.monotonic() < end:
            time.sleep(0.005)

    def wire(self) -> dict:
        with self._lock:
            return {"results": self.sent, "copy_s": self.copy_s, "send_s": self.send_s}

    def _loop(self) -> None:
        while True:
            conn, rid, fut = self._queue.get()
            try:
                t0 = time.perf_counter()
                res = fut.result().cpu().numpy()
                t1 = time.perf_counter()
                conn.send("result", {"rid": rid, **codec.array_header(res)},
                          codec.array_bytes(res))
                with self._lock:
                    self.copy_s += t1 - t0
                    self.send_s += time.perf_counter() - t1
                    self.sent += 1
            except (ConnectionClosed, OSError):
                pass  # parent gone; its sweep fails the pending future
            except Exception as exc:
                try:
                    conn.send("error", {"rid": rid, **_etype(exc)})
                except (ConnectionClosed, OSError):
                    pass
            finally:
                self._queue.task_done()


def _on_submit(conn: _Conn, worker, results: _Results, hdr: dict,
               payload: bytes) -> None:
    rid = hdr.get("rid")
    try:
        want = hdr.get("plan_hash")
        if want is not None and want != worker.plan_hash:
            from .errors import PlanMismatch

            raise PlanMismatch(
                f"frame stamped for plan {want!r}, worker serves "
                f"{worker.plan_hash!r}"
            )
        frame = codec.decode_array(hdr, payload)
        fut = worker.submit(
            frame,
            stream_id=hdr.get("sid"),
            deadline_ms=hdr.get("deadline_ms"),
            block=False,  # the serve loop must never wedge on a full queue
        )
    except Exception as exc:
        try:
            conn.send("error", {"rid": rid, **_etype(exc)})
        except (ConnectionClosed, OSError):
            pass
        return

    fut.add_done_callback(lambda f: results.put(conn, rid, f))


def _on_call(conn: _Conn, worker, results: _Results, hdr: dict) -> None:
    rid, op = hdr.get("rid"), hdr.get("op")
    a = hdr.get("args") or {}
    try:
        if op == "open_stream":
            result = worker.open_stream(a["sid"], alpha=a.get("alpha", 0.0))
        elif op == "close_stream":
            result = worker.close_stream(a["sid"])
        elif op == "quarantine":
            result = bool(worker.quarantine(a["sid"]))
        elif op == "warm_streams":
            result = list(worker.warm_streams())
        elif op == "queue_depth":
            result = worker.queue_depth()
        elif op == "flush":
            result = bool(worker.flush(timeout=a.get("timeout")))
        elif op == "stats":
            st = worker.stats()
            result = st.as_dict()
            result["latency_samples"] = list(st.latency_samples)
            # extra fields: the process's launch counters (its one engine's)
            # and the result thread's seconds
            from repro_torch.kernels import launch_counts

            result["launches"] = launch_counts()
            result["wire"] = results.wire()
        elif op == "snapshot_now":
            result = _push_snapshots(conn, worker)
        elif op == "ping":
            result = "pong"
        else:
            raise ValueError(f"unknown rpc op {op!r}")
    except (ConnectionClosed, OSError):
        raise
    except Exception as exc:
        try:
            conn.send("ack", {"rid": rid, "ok": False, **_etype(exc)})
        except (ConnectionClosed, OSError):
            pass
        return
    conn.send("ack", {"rid": rid, "ok": True, "result": result})


def _on_restore(conn: _Conn, worker, hdr: dict, payload: bytes) -> None:
    rid = hdr.get("rid")
    try:
        carry = codec.decode_array(hdr, payload)
        snap = CarrySnapshot(
            sid=hdr["sid"],
            carry=carry,
            alpha=float(hdr["alpha"]),
            frames_seen=int(hdr["frames_seen"]),
            plan_hash=hdr["plan_hash"],
            taken_at=time.monotonic(),
        )
        ok = bool(worker.restore_carry(snap.sid, snap))
    except (ConnectionClosed, OSError):
        raise
    except Exception as exc:
        try:
            conn.send("ack", {"rid": rid, "ok": False, **_etype(exc)})
        except (ConnectionClosed, OSError):
            pass
        return
    conn.send("ack", {"rid": rid, "ok": True, "result": ok})


def _serve(conn: _Conn, worker, results: _Results) -> None:
    """Message loop until the connection tears (raises) or SHUTDOWN."""
    conn.sock.settimeout(0.5)
    while True:
        try:
            name, hdr, payload = codec.read_message(conn.sock.recv, conn.stall_s)
        except TimeoutError:
            if os.getppid() == 1:
                os._exit(0)
            if conn.broken:
                raise ConnectionClosed("send side marked the socket broken")
            continue
        if name == "submit":
            _on_submit(conn, worker, results, hdr, payload)
        elif name == "call":
            _on_call(conn, worker, results, hdr)
        elif name == "restore":
            _on_restore(conn, worker, hdr, payload)
        elif name == "shutdown":
            worker.close(timeout=float(hdr.get("timeout", 10.0)))
            results.drain(timeout=float(hdr.get("timeout", 10.0)))
            raise SystemExit(0)
        # anything else: tolerated (forward-compatible control traffic)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.fleet.remote_worker",
        description="child half of repro_torch.fleet.remote.SubprocessWorker",
    )
    ap.add_argument("--wid", required=True,
                    help="worker id, JSON-encoded (str/int)")
    ap.add_argument("--connect", required=True,
                    help="router address: unix:<path> or tcp:<host>:<port>")
    ap.add_argument("--reconnect-attempts", type=int, default=5)
    ap.add_argument("--reconnect-backoff-s", type=float, default=0.05)
    args = ap.parse_args(argv)
    wid = json.loads(args.wid)

    worker = None
    results = None
    reconnect = False
    while True:
        try:
            sock = _dial(
                args.connect, args.reconnect_attempts,
                args.reconnect_backoff_s,
            )
        except (ConnectionRefusedError, ValueError) as exc:
            print(f"[remote_worker {wid!r}] {exc}", file=sys.stderr)
            return 1
        conn = _Conn(sock)
        stop = threading.Event()
        try:
            sock.settimeout(30.0)
            conn.send("hello", {
                "wid": wid, "pid": os.getpid(), "reconnect": reconnect,
            })
            name, hdr, _ = codec.read_message(sock.recv)
            if name != "plan":
                raise CodecError(f"expected plan, got {name!r}")
            conn.stall_s = float(hdr.get("heartbeat_timeout_s", conn.stall_s))
            if worker is None:
                # imports torch and rebuilds the BGPlan, deferred to here
                # so a doomed child (bad address) fails before paying for it
                from .worker import LocalWorker

                try:
                    kw = dict(hdr.get("worker_kwargs") or {})
                    kw["engine_kwargs"] = kw.get("engine_kwargs") or None
                    worker = LocalWorker(
                        wid, hdr["payload"], device=hdr.get("device", "cuda"),
                        mesh="auto", snapshots=True, **kw,
                    )
                    # before READY: the parent's start timeout covers an
                    # nvcc build, no sweep timer runs during it
                    worker.load_kernels()
                except Exception as exc:
                    # structured construction failure (PlanMismatch, no
                    # card, a kernel that does not build): tell the parent,
                    # then die; fatal, no point reconnecting with the same
                    # payload
                    conn.send("error", _etype(exc))
                    return 1
                results = _Results()
            conn.send("ready", {
                "plan_hash": worker.plan_hash, "pid": os.getpid(),
            })
            hb = threading.Thread(
                target=_heartbeat_loop,
                args=(conn, worker,
                      float(hdr.get("heartbeat_interval_s", 0.25)), stop),
                daemon=True,
            )
            hb.start()
            if worker.temporal:
                threading.Thread(
                    target=_snapshot_loop,
                    args=(conn, worker,
                          float(hdr.get("snapshot_interval_s", 0.25)), stop),
                    daemon=True,
                ).start()
            _serve(conn, worker, results)
        except SystemExit as exc:
            stop.set()
            conn.close()
            return int(exc.code or 0)
        except (ConnectionClosed, CodecError, OSError) as exc:
            # torn transport: keep the worker state, rebuild the socket
            print(
                f"[remote_worker {wid!r}] connection lost ({exc}); "
                f"reconnecting",
                file=sys.stderr,
            )
            stop.set()
            conn.close()
            reconnect = True
            continue


if __name__ == "__main__":
    sys.exit(main())
