"""Length-prefixed binary frame codec for the process-spanning worker RPC:
the port of ``repro/fleet/codec.py``, byte for byte the same wire format.

The :class:`~repro_torch.fleet.worker.Worker` protocol was designed so
every argument travels as plain data; this module is the wire form of that
design. One message =

    ``[preamble 24 B][header JSON <= 1 MiB][payload <= 1 GiB]``

with a fixed preamble::

    offset  size  field
         0     4  magic  b"BGF1"
         4     1  format version (1)
         5     1  message type (see MSG_TYPES)
         6     2  reserved (zero)
         8     4  header length   (big-endian u32)
        12     8  payload length  (big-endian u64)
        20     4  CRC32 of preamble[0:20] + header + payload

The header is UTF-8 JSON carrying the plain-data fields (``rid``, stream
id, frame geometry/dtype via :func:`array_header`, the plan hash); the
payload is the raw C-order frame/carry bytes. Nothing on the wire is
pickled, so a corrupt or adversarial peer can at worst produce a
:class:`CodecError`, never code execution or an unbounded allocation (both
length fields are hard-capped *before* any read or allocation).

Validation contract:

  * truncated preamble/header/payload -> :class:`CodecError`
  * bad magic / unknown version / unknown message type -> :class:`CodecError`
  * flipped bit anywhere in the message -> :class:`CodecError` (the CRC
    covers the preamble's type/length fields too, so a flip that lands on
    another *valid* type byte still cannot decode as the wrong message)
  * length field beyond the cap -> :class:`CodecError` before allocation
  * clean EOF *between* messages -> :class:`ConnectionClosed` (the one
    non-error close signal, so a graceful peer shutdown is distinguishable
    from a torn frame)

Array round-trip: :func:`array_header` + :func:`array_bytes` on the send
side, :func:`decode_array` on the receive side (dtype/shape/byte-count all
re-validated). Host data only: numpy arrays, or CPU tensors.

bfloat16 travels under the name ``"bfloat16"`` with its 2-byte words, as
in the JAX package, which spells it through ``ml_dtypes``. This module
imports neither JAX nor ``ml_dtypes``: a CPU ``torch.bfloat16`` tensor, a
numpy array whose dtype is named ``bfloat16`` (an ``ml_dtypes`` array a
caller holds), or the ``uint16`` bits of either with ``bfloat16=True`` go
out as ``"bfloat16"``, and ``"bfloat16"`` comes back as a CPU
``torch.bfloat16`` tensor. Every other dtype of kind ``b``, ``i``, ``u``
or ``f`` travels and comes back as a numpy array; object and void dtypes
are refused.
"""
from __future__ import annotations

import json
import struct
import time
import zlib
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .errors import CodecError, ConnectionClosed

__all__ = [
    "MSG_TYPES",
    "MAX_HEADER_BYTES",
    "MAX_PAYLOAD_BYTES",
    "encode",
    "decode",
    "read_message",
    "send_all",
    "array_header",
    "array_bytes",
    "decode_array",
]

MAGIC = b"BGF1"
VERSION = 1
_PREAMBLE = struct.Struct(">4sBBHIQI")  # magic ver type reserved hlen plen crc
PREAMBLE_BYTES = _PREAMBLE.size

# Hard caps checked BEFORE any allocation: a flipped bit in a length field
# must produce a structured error, not a 2**60-byte allocation or a read
# that never completes.
MAX_HEADER_BYTES = 1 << 20
MAX_PAYLOAD_BYTES = 1 << 30

# Message types. Values are the wire bytes; names are what the transport
# layers (SubprocessWorker / remote_worker) dispatch on.
MSG_TYPES: Dict[str, int] = {
    "hello": 1,       # child -> parent, on every (re)connect
    "plan": 2,        # parent -> child: controller payload + engine config
    "ready": 3,       # child -> parent: plan rebuilt, hash enclosed
    "submit": 4,      # parent -> child: one frame (payload = frame bytes)
    "result": 5,      # child -> parent: one denoised frame
    "error": 6,       # child -> parent: structured failure (typed)
    "call": 7,        # parent -> child: sync control RPC (op in header)
    "ack": 8,         # child -> parent: sync RPC response
    "heartbeat": 9,   # child -> parent: liveness + queue depth + stats
    "snapshot": 10,   # child -> parent: one stream's warm-carry snapshot
    "restore": 11,    # parent -> child: restore a carry (payload = bytes)
    "shutdown": 12,   # parent -> child: graceful drain-and-exit
}
_TYPE_NAMES = {v: k for k, v in MSG_TYPES.items()}

# dtypes allowed on the wire besides "bfloat16": everything the serving
# stack ships (float frames, quantized outputs, float32 carries) plus the
# common numeric types. Object/void dtypes are refused: they would
# deserialize through pickle, which this codec exists to avoid.
_WIRE_KINDS = frozenset("biuf")
BFLOAT16 = "bfloat16"


def encode(msg_type: str, header: dict, payload: bytes = b"") -> bytes:
    """Serialize one message. ``header`` must be JSON-plain data."""
    try:
        mt = MSG_TYPES[msg_type]
    except KeyError:
        raise CodecError(f"unknown message type {msg_type!r}") from None
    hdr = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    if len(hdr) > MAX_HEADER_BYTES:
        raise CodecError(f"header too large: {len(hdr)} bytes")
    if len(payload) > MAX_PAYLOAD_BYTES:
        raise CodecError(f"payload too large: {len(payload)} bytes")
    pre = _PREAMBLE.pack(MAGIC, VERSION, mt, 0, len(hdr), len(payload), 0)
    crc = zlib.crc32(payload, zlib.crc32(hdr, zlib.crc32(pre[:20])))
    return (
        _PREAMBLE.pack(
            MAGIC, VERSION, mt, 0, len(hdr), len(payload), crc & 0xFFFFFFFF
        )
        + hdr
        + payload
    )


def _parse_preamble(raw: bytes) -> Tuple[str, int, int, int]:
    magic, ver, mt, _res, hlen, plen, crc = _PREAMBLE.unpack(raw)
    if magic != MAGIC:
        raise CodecError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise CodecError(f"unknown codec version {ver}")
    name = _TYPE_NAMES.get(mt)
    if name is None:
        raise CodecError(f"unknown message type byte {mt}")
    if hlen > MAX_HEADER_BYTES:
        raise CodecError(f"header length {hlen} exceeds cap")
    if plen > MAX_PAYLOAD_BYTES:
        raise CodecError(f"payload length {plen} exceeds cap")
    return name, hlen, plen, crc


def _finish(name: str, pre: bytes, hdr: bytes, payload: bytes, crc: int):
    calc = zlib.crc32(payload, zlib.crc32(hdr, zlib.crc32(pre[:20])))
    if (calc & 0xFFFFFFFF) != crc:
        raise CodecError(f"CRC mismatch on {name!r} message")
    try:
        header = json.loads(hdr.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise CodecError(f"undecodable header on {name!r}: {exc}") from None
    if not isinstance(header, dict):
        raise CodecError(f"header must be a JSON object, got {type(header)}")
    return name, header, payload


def decode(data: bytes) -> Tuple[str, dict, bytes]:
    """Decode exactly one message from ``data`` (tests/fuzzing entry)."""
    if len(data) < PREAMBLE_BYTES:
        raise CodecError(
            f"truncated preamble: {len(data)} < {PREAMBLE_BYTES} bytes"
        )
    name, hlen, plen, crc = _parse_preamble(data[:PREAMBLE_BYTES])
    end = PREAMBLE_BYTES + hlen + plen
    if len(data) < end:
        raise CodecError(f"truncated {name!r} message: {len(data)} < {end}")
    hdr = data[PREAMBLE_BYTES:PREAMBLE_BYTES + hlen]
    payload = data[PREAMBLE_BYTES + hlen:end]
    return _finish(name, data[:PREAMBLE_BYTES], hdr, payload, crc)


def read_message(recv: Callable[[int], bytes],
                 stall_s: float = 0.0) -> Tuple[str, dict, bytes]:
    """Read one message from ``recv(n) -> up-to-n-bytes`` (a socket's
    ``recv``). EOF at a message boundary raises :class:`ConnectionClosed`
    (clean close); EOF mid-message, or a message that makes no progress for
    ``stall_s`` seconds, raises :class:`CodecError` (torn frame). A
    ``socket.timeout`` before any byte arrives propagates unchanged: idle
    is the caller's policy decision, not a codec error. (``stall_s=0``, the
    JAX codec's rule: the first timeout mid-message tears it; the port's
    transport waits longer, as a full-HD frame is 8.3 MB.)"""

    def _exact(n: int, mid: bool) -> bytes:
        buf = bytearray()
        last = time.monotonic()  # the last progress
        while len(buf) < n:
            try:
                chunk = recv(n - len(buf))
            except TimeoutError:
                if not mid and not buf:
                    raise  # idle at a boundary: caller decides
                if time.monotonic() - last < stall_s:
                    continue
                raise CodecError(
                    f"stalled mid-message after {len(buf)}/{n} bytes"
                ) from None
            if not chunk:
                if not mid and not buf:
                    raise ConnectionClosed("peer closed between messages")
                raise CodecError(
                    f"truncated: EOF after {len(buf)}/{n} bytes"
                )
            buf += chunk
            mid = True
            last = time.monotonic()
        return bytes(buf)

    raw = _exact(PREAMBLE_BYTES, mid=False)
    name, hlen, plen, crc = _parse_preamble(raw)
    hdr = _exact(hlen, mid=True) if hlen else b""
    payload = _exact(plen, mid=True) if plen else b""
    return _finish(name, raw, hdr, payload, crc)


def send_all(sock, data: bytes, stall_s: float) -> None:
    """``sock.sendall(data)`` for a socket with a short timeout: a send
    that makes progress goes on, one that makes none for ``stall_s``
    seconds raises ``TimeoutError`` (an ``OSError``). A short timeout is
    what lets the reader of the same socket poll its stop flag; a multi-MB
    message must not be torn by it."""
    view = memoryview(data)
    last = time.monotonic()
    while view:
        try:
            n = sock.send(view)
        except TimeoutError:
            if time.monotonic() - last >= stall_s:
                raise
            continue
        view = view[n:]
        last = time.monotonic()


# ----------------------------------------------------------------- arrays
def _host(arr, bfloat16: bool) -> Tuple[np.ndarray, bool]:
    """``(numpy array, is_bf16)``: a bf16 array as its ``uint16`` bits."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise CodecError(
                f"the wire takes host data; copy the {arr.device} tensor to "
                f"the CPU first"
            )
        if arr.dtype == torch.bfloat16:
            return arr.detach().contiguous().view(torch.int16).numpy().view(np.uint16), True
        arr = arr.detach().numpy()
    arr = np.asarray(arr)
    if arr.dtype.name == BFLOAT16:  # an ml_dtypes array, by name
        return arr.view(np.uint16), True
    if bfloat16:
        if arr.dtype != np.uint16:
            raise CodecError(f"bfloat16=True takes uint16 bits, got {arr.dtype}")
        return arr, True
    return arr, False


def array_header(arr, *, bfloat16: bool = False) -> dict:
    """The geometry/dtype header fields for one array payload.

    ``arr`` is a numpy array or a CPU tensor; ``bfloat16=True`` sends
    ``uint16`` bits as ``"bfloat16"``. The shape is the array's own (a 0-d
    array stays 0-d), and the bytes the header describes are C order,
    whatever the array's layout in memory (:func:`array_bytes`)."""
    arr, bf16 = _host(arr, bfloat16)
    if bf16:
        return {"shape": list(arr.shape), "dtype": BFLOAT16}
    if arr.dtype.kind not in _WIRE_KINDS:
        raise CodecError(f"dtype {arr.dtype} not allowed on the wire")
    return {"shape": list(arr.shape), "dtype": arr.dtype.str}


def array_bytes(arr, *, bfloat16: bool = False) -> bytes:
    """The C-order payload bytes :func:`array_header` describes."""
    return _host(arr, bfloat16)[0].tobytes()


def decode_array(header: dict, payload: bytes):
    """Rebuild the array an :func:`array_header` + :func:`array_bytes` pair
    shipped, re-validating geometry, dtype, and byte count: a numpy array,
    or a CPU ``torch.bfloat16`` tensor for ``"bfloat16"``. The result owns
    its memory (no view of a network buffer escapes)."""
    try:
        shape = tuple(int(s) for s in header["shape"])
        name = header["dtype"]
        bf16 = name == BFLOAT16
        dtype = np.dtype(np.uint16) if bf16 else np.dtype(name)
    except (KeyError, TypeError, ValueError) as exc:
        raise CodecError(f"bad array header: {exc}") from None
    if dtype.kind not in _WIRE_KINDS:
        raise CodecError(f"dtype {dtype} not allowed on the wire")
    if any(s < 0 for s in shape):
        raise CodecError(f"negative dimension in shape {shape}")
    want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape \
        else dtype.itemsize
    if want != len(payload):
        raise CodecError(
            f"payload is {len(payload)} bytes but shape {shape} dtype "
            f"{name} needs {want}"
        )
    arr = np.frombuffer(payload, dtype=dtype).reshape(shape).copy()
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr
