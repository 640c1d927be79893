"""The port's wire codec (``repro_torch.fleet.codec``): the cases of
tests/test_fleet_codec.py, with the half-precision case on
``torch.bfloat16``, plus the cross-package cases.

Seeded numpy fuzz of the framing/validation contract: random geometries and
dtypes round-trip bit-exact; truncation at EVERY byte boundary of a real
message and random bit flips anywhere in it decode to a structured
``CodecError`` (never a hang, never a partial object); the length caps fire
before allocation; and ``decode_array`` refuses geometry/dtype/byte-count
mismatches. bfloat16 travels by name with no ``ml_dtypes`` in the port: a
CPU ``torch.bfloat16`` tensor out, the same back.

Across the packages, on numpy inputs from a seed: the JAX codec's bytes
decode in the port and the port's in JAX, for float32, uint8 and bf16 by
name (``ml_dtypes`` on the JAX side only). The JAX package is imported in a
fixture, so a host without JAX collects this file.
"""
import io
import json
import struct

import numpy as np
import pytest
import torch

from repro_torch.fleet import CodecError, ConnectionClosed
from repro_torch.fleet.codec import (
    MAX_HEADER_BYTES,
    MAX_PAYLOAD_BYTES,
    MSG_TYPES,
    PREAMBLE_BYTES,
    array_bytes,
    array_header,
    decode,
    decode_array,
    encode,
    read_message,
)

WIRE_DTYPES = [
    np.float32, np.float64, np.float16, torch.bfloat16,
    np.int8, np.int16, np.int32, np.int64,
    np.uint8, np.uint16, np.uint32, np.uint64,
    np.bool_,
]


def _as(raw: np.ndarray, dtype):
    """``raw`` in ``dtype``: a numpy array, or a CPU bf16 tensor."""
    if dtype is torch.bfloat16:
        return torch.from_numpy(raw.astype(np.float32)).to(torch.bfloat16)
    return raw.astype(dtype)


def _same(out, arr) -> bool:
    """Same dtype, shape and bytes."""
    if isinstance(arr, torch.Tensor):
        return (isinstance(out, torch.Tensor) and out.dtype == arr.dtype
                and out.shape == arr.shape and array_bytes(out) == array_bytes(arr))
    return (isinstance(out, np.ndarray) and out.dtype == arr.dtype
            and out.shape == arr.shape and np.array_equal(out, arr))


def _random_array(rng):
    ndim = int(rng.integers(0, 5))
    shape = tuple(int(rng.integers(0, 6)) for _ in range(ndim))
    dtype = WIRE_DTYPES[int(rng.integers(0, len(WIRE_DTYPES)))]
    raw = rng.integers(0, 256, size=shape, dtype=np.uint8, endpoint=False)
    return _as(raw, dtype)


def _chunked_reader(data, chunk=7):
    """A recv(n) over a byte string that returns ragged chunks, then ''."""
    buf = io.BytesIO(data)
    return lambda n: buf.read(min(n, chunk))


# ------------------------------------------------------------- round trips
def test_roundtrip_fuzz_geometries_and_dtypes():
    """200 random (msg_type, header, array) messages survive encode ->
    decode and encode -> ragged-chunk read_message bit-exactly."""
    names = sorted(MSG_TYPES)
    for trial in range(200):
        rng = np.random.default_rng(1000 + trial)
        arr = _random_array(rng)
        name = names[int(rng.integers(0, len(names)))]
        header = dict(array_header(arr), rid=trial, sid=f"s{trial}")
        wire = encode(name, header, array_bytes(arr))

        got_name, got_header, payload = decode(wire)
        assert got_name == name
        assert got_header == json.loads(json.dumps(header))
        assert _same(decode_array(got_header, payload), arr)

        chunk = int(rng.integers(1, 11))
        got_name2, got_header2, payload2 = read_message(
            _chunked_reader(wire, chunk=chunk)
        )
        assert (got_name2, got_header2, payload2) == (
            got_name, got_header, payload
        )


def test_empty_payload_and_empty_header_roundtrip():
    name, header, payload = decode(encode("heartbeat", {}))
    assert name == "heartbeat" and header == {} and payload == b""


def test_unknown_message_type_refused_at_encode():
    with pytest.raises(CodecError, match="unknown message type"):
        encode("gossip", {})


# ------------------------------------------------- truncation: every cut
def test_truncation_at_every_byte_boundary_is_structured():
    """Cutting a real message at EVERY byte offset yields CodecError from
    decode()."""
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    wire = encode("result", dict(array_header(arr), rid=1), array_bytes(arr))
    for cut in range(len(wire)):
        with pytest.raises(CodecError):
            decode(wire[:cut])


def test_streamed_truncation_mid_message_vs_boundary():
    """read_message: EOF at a message boundary is ConnectionClosed (clean
    peer shutdown); EOF anywhere mid-message is CodecError (torn frame)."""
    arr = np.ones((3, 5), np.float32)
    wire = encode("submit", dict(array_header(arr), rid=7), array_bytes(arr))
    with pytest.raises(ConnectionClosed):
        read_message(_chunked_reader(b""))
    rng = np.random.default_rng(2)
    cuts = {1, PREAMBLE_BYTES - 1, PREAMBLE_BYTES, len(wire) - 1} | {
        int(c) for c in rng.integers(1, len(wire), size=32)
    }
    for cut in cuts:
        with pytest.raises(CodecError, match="EOF|stalled"):
            read_message(_chunked_reader(wire[:cut]))


def test_idle_timeout_at_boundary_propagates_mid_message_does_not():
    """A TimeoutError before any byte is the caller's idle policy and
    propagates; a timeout after partial bytes is a torn frame."""
    def idle(n):
        raise TimeoutError("idle")

    with pytest.raises(TimeoutError):
        read_message(idle)

    wire = encode("ack", {"rid": 1})
    buf = io.BytesIO(wire[:4])

    def stall(n):
        chunk = buf.read(n)
        if not chunk:
            raise TimeoutError("stalled")
        return chunk

    with pytest.raises(CodecError, match="stalled mid-message"):
        read_message(stall)


# ----------------------------------------------------------- bit-flip fuzz
def test_bitflip_fuzz_never_yields_wrong_payload():
    """400 single-bit flips at random offsets anywhere in the wire bytes,
    preamble fields included, decode to CodecError, never to a wrong
    message."""
    arr = np.arange(60, dtype=np.int16).reshape(5, 12)
    wire = bytearray(
        encode("snapshot", dict(array_header(arr), sid=3), array_bytes(arr))
    )
    rng = np.random.default_rng(3)
    for _ in range(400):
        i = int(rng.integers(0, len(wire)))
        bit = 1 << int(rng.integers(0, 8))
        flipped = bytes(wire[:i] + bytes([wire[i] ^ bit]) + wire[i + 1:])
        with pytest.raises(CodecError):
            decode(flipped)


@pytest.mark.parametrize("dtype", [np.float16, torch.bfloat16], ids=["float16", "bfloat16"])
def test_bitflip_fuzz_half_precision(dtype):
    """The 16-bit storage dtypes the bf16 carry/snapshot wire ships get the
    same single-bit-flip guarantee as the int16 message above."""
    arr = _as((np.arange(48, dtype=np.float32) / 7.0).reshape(4, 12), dtype)
    wire = bytearray(
        encode("snapshot", dict(array_header(arr), sid=5), array_bytes(arr))
    )
    assert len(array_bytes(arr)) == 48 * 2
    rng = np.random.default_rng(0xBF16)
    for _ in range(200):
        i = int(rng.integers(0, len(wire)))
        bit = 1 << int(rng.integers(0, 8))
        flipped = bytes(wire[:i] + bytes([wire[i] ^ bit]) + wire[i + 1:])
        with pytest.raises(CodecError):
            decode(flipped)


def test_bad_magic_version_and_type_bytes():
    good = encode("hello", {"wid": 0})
    for i in (0, 4, 5):  # magic, version, message-type bytes
        bad = bytearray(good)
        bad[i] ^= 0xFF
        with pytest.raises(CodecError):
            decode(bytes(bad))


# ------------------------------------------------------------- length caps
def test_length_caps_fire_before_allocation():
    """A forged preamble claiming a 2**60-byte payload must be refused
    from the 24 preamble bytes alone: no read, no allocation."""
    pre = struct.Struct(">4sBBHIQI")
    forged = pre.pack(b"BGF1", 1, MSG_TYPES["submit"], 0, 10, 1 << 60, 0)
    with pytest.raises(CodecError, match="exceeds cap"):
        decode(forged)
    forged = pre.pack(
        b"BGF1", 1, MSG_TYPES["submit"], 0, MAX_HEADER_BYTES + 1, 0, 0
    )
    with pytest.raises(CodecError, match="exceeds cap"):
        decode(forged)

    calls = {"n": 0}

    def recv(n):
        calls["n"] += 1
        assert calls["n"] <= 1, "codec kept reading past a capped preamble"
        return pre.pack(b"BGF1", 1, 4, 0, 0, MAX_PAYLOAD_BYTES + 1, 0)

    with pytest.raises(CodecError, match="exceeds cap"):
        read_message(recv)


def test_oversize_refused_at_encode_too():
    with pytest.raises(CodecError, match="payload too large"):
        encode("submit", {}, b"\0" * (MAX_PAYLOAD_BYTES + 1))


# ------------------------------------------------------------- array layer
def test_array_header_refuses_object_dtype():
    with pytest.raises(CodecError, match="not allowed on the wire"):
        array_header(np.array([{"a": 1}], dtype=object))


def test_decode_array_revalidates_everything():
    arr = np.zeros((4, 6), np.float32)
    hdr, payload = array_header(arr), array_bytes(arr)
    # geometry lies about the byte count
    with pytest.raises(CodecError, match="needs"):
        decode_array({"shape": [4, 7], "dtype": "<f4"}, payload)
    # dtype lies about the byte count
    with pytest.raises(CodecError, match="needs"):
        decode_array({"shape": [4, 6], "dtype": "<f8"}, payload)
    # smuggled object dtype in an otherwise-valid header
    with pytest.raises(CodecError, match="not allowed"):
        decode_array({"shape": [1], "dtype": "|O"}, payload)
    # negative dimension
    with pytest.raises(CodecError, match="negative"):
        decode_array({"shape": [-4, 6], "dtype": "<f4"}, payload)
    # missing fields / junk
    with pytest.raises(CodecError, match="bad array header"):
        decode_array({"dtype": "<f4"}, payload)
    with pytest.raises(CodecError, match="bad array header"):
        decode_array({"shape": [4, 6], "dtype": "not-a-dtype"}, payload)
    # the straight path still works and owns its memory (no frombuffer view
    # of a network buffer escapes)
    out = decode_array(hdr, payload)
    assert out.flags.owndata or out.base is None
    assert np.array_equal(out, arr)


def test_bfloat16_travels_by_name_not_void():
    """A CPU torch.bfloat16 tensor ships under the name "bfloat16" (2-byte
    words) and comes back as one; the void spelling is refused outright,
    and so is a tensor on any other device than the CPU."""
    arr = torch.tensor([1.5, -2.25, 65280.0], dtype=torch.bfloat16)
    hdr = array_header(arr)
    assert hdr == {"shape": [3], "dtype": "bfloat16"}
    out = decode_array(hdr, array_bytes(arr))
    assert out.dtype == torch.bfloat16 and torch.equal(out, arr)
    assert len(array_bytes(arr)) == 6
    # the uint16 bits of a bf16 array ship the same way when asked
    bits = arr.view(torch.int16).numpy().view(np.uint16)
    assert array_header(bits, bfloat16=True) == hdr
    assert array_bytes(bits, bfloat16=True) == array_bytes(arr)
    with pytest.raises(CodecError, match="uint16"):
        array_header(np.zeros(3, np.float32), bfloat16=True)
    with pytest.raises(CodecError, match="not allowed"):
        decode_array({"shape": [3], "dtype": "<V2"}, array_bytes(arr))
    with pytest.raises(CodecError, match="not allowed"):
        array_header(np.zeros(3, np.dtype("V2")))
    with pytest.raises(CodecError, match="host data"):
        array_header(torch.zeros(3, device="meta"))
    # non-finite bit patterns ride the snapshot wire bit-exact
    specials = torch.tensor([np.nan, np.inf, -np.inf, 0.0]).to(torch.bfloat16)
    out2 = decode_array(array_header(specials), array_bytes(specials))
    assert array_bytes(out2) == array_bytes(specials)
    # byte-count validation knows the 2-byte item size
    with pytest.raises(CodecError, match="needs"):
        decode_array({"shape": [4], "dtype": "bfloat16"}, array_bytes(arr))


def test_decode_array_scalar_shape():
    arr = np.asarray(np.float64(3.25))
    out = decode_array(array_header(arr), array_bytes(arr))
    assert out.shape == () and float(out) == 3.25


# ----------------------------------------------------------- cross-package
@pytest.fixture
def jcodec():
    """The JAX package's codec, with ml_dtypes (imported here, not at module
    level, so a host without JAX can collect this file)."""
    pytest.importorskip("jax")
    ml_dtypes = pytest.importorskip("ml_dtypes")
    from repro.fleet import codec

    return codec, ml_dtypes


def _seeded(kind: str, seed: int = 7):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-300.0, 300.0, size=(3, 5, 4)).astype(np.float32)
    if kind == "uint8":
        return rng.integers(0, 256, size=(3, 5, 4), dtype=np.uint8)
    return vals


@pytest.mark.parametrize("kind", ["float32", "uint8", "bfloat16"])
def test_jax_bytes_decode_in_port_and_back(jcodec, kind):
    """The same message from both packages is the same bytes; each decodes
    the other's to the same values (bf16 by name: an ml_dtypes array on the
    JAX side, a torch.bfloat16 tensor in the port)."""
    jc, ml_dtypes = jcodec
    vals = _seeded(kind)
    if kind == "bfloat16":
        j_arr = vals.astype(ml_dtypes.bfloat16)
        p_arr = torch.from_numpy(vals).to(torch.bfloat16)
    else:
        j_arr = p_arr = vals
    j_wire = jc.encode("snapshot", dict(jc.array_header(j_arr), sid=1), j_arr.tobytes())
    p_wire = encode("snapshot", dict(array_header(p_arr), sid=1), array_bytes(p_arr))
    assert j_wire == p_wire

    name, hdr, payload = decode(j_wire)  # JAX's bytes in the port
    got = decode_array(hdr, payload)
    assert name == "snapshot" and hdr["sid"] == 1
    if kind == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), j_arr.astype(np.float32))
    else:
        assert got.dtype == vals.dtype
        np.testing.assert_array_equal(got, vals)

    name, hdr, payload = jc.decode(p_wire)  # the port's bytes in JAX
    back = jc.decode_array(hdr, payload)
    assert back.dtype == j_arr.dtype and back.tobytes() == j_arr.tobytes()
