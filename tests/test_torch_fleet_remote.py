"""The port's process-isolated workers (``repro_torch.fleet.remote``): the
cases of tests/test_fleet_remote.py on CPU children, plus the port's own.

Every test runs under a hard SIGALRM deadline (autouse fixture): the claim
under test is "crossing the process boundary can fail, but it can never
hang", so a hung test IS the failure mode, and the alarm turns it into a
loud one. Every future's wait is bounded too.

The load-bearing set:

  * ``test_subprocess_parity_bit_equal_with_local``: the same controller
    payload served through a child process gives bit-identical results to
    the in-process worker, warm temporal carries included.
  * ``test_sigkill_mid_flight_resolves_every_future``.
  * ``test_snapshot_restore_bit_equivalence``: a stream restored from a
    shipped snapshot continues bit-identically to one that never failed.
  * transport-fault tests: an injected dropped submit fails by sweep
    (never hangs); an injected truncation desynchronizes the framing, the
    child reconnects, and warm carries survive in the child process; a
    suppressed heartbeat flips liveness and recovers.

Added in the port: a bf16 child ships its snapshots as bf16 words, bit for
bit the carry of a local worker fed the same frames; a child asked for the
card on a host without one refuses (ERROR, then exit 1) and never serves on
the CPU. A child's results are host arrays, a local worker's CPU tensors
here.
"""
import signal
import time

import numpy as np
import pytest
import torch

from repro_torch.core import BGConfig
from repro_torch.fleet import (
    LocalWorker,
    PlanController,
    PlanMismatch,
    SubprocessWorker,
    WorkerDown,
)
from repro_torch.plan import BGPlan
from repro_torch.reliability import Fault, FaultInjector

CFG = BGConfig(r=4, sigma_s=4.0, sigma_r=60.0)
H, W = 24, 32
ALPHA = 0.6
TEST_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def hard_deadline():
    """SIGALRM backstop: a hung RPC/future is the bug class under test."""
    def on_alarm(signum, frame):
        raise AssertionError(
            f"test exceeded the {TEST_TIMEOUT_S}s hard deadline: a worker RPC "
            f"or future hung"
        )

    prev = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


@pytest.fixture(scope="module")
def payload():
    return PlanController(
        cfg=CFG, height=H, width=W, streams_per_worker=2,
        temporal=True, sharded=False, device="cpu", cache=False,
    ).payload()


def _frame(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 255.0, size=(H, W)).astype(np.float32)


def _sub(payload, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("max_batch", 4)
    kw.setdefault("batch_window_ms", 1.0)
    return SubprocessWorker("sub", payload, **kw)


def _local(wid, payload, **kw):
    return LocalWorker(wid, payload, device="cpu", max_batch=4, batch_window_ms=1.0, **kw)


# ----------------------------------------------------------------- parity
def test_subprocess_parity_bit_equal_with_local(payload):
    """4 warm frames on 2 streams: the child-process engine's outputs are
    bit-identical to the in-process engine's on the same payload."""
    frames = {s: [_frame(10 * s + t) for t in range(4)] for s in (0, 1)}
    local = _local("loc", payload)
    sub = _sub(payload)
    try:
        for w in (local, sub):
            for s in (0, 1):
                w.open_stream(s, alpha=ALPHA)
        for t in range(4):
            futs = {
                (n, s): w.submit(frames[s][t], stream_id=s)
                for n, w in (("loc", local), ("sub", sub))
                for s in (0, 1)
            }
            for s in (0, 1):
                a = futs[("loc", s)].result(timeout=60).numpy()
                b = futs[("sub", s)].result(timeout=60)
                assert isinstance(b, np.ndarray)  # a child's result is host data
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        assert sorted(sub.warm_streams()) == [0, 1]
        st = sub.stats()
        assert st.completed == 8 and st.failed == 0
        assert sub.launches() == {}  # the CPU child launches no kernel
    finally:
        sub.close(timeout=10)
        local.close(timeout=10)


def test_wid_and_sid_must_be_json_plain(payload):
    with pytest.raises(TypeError, match="JSON-plain"):
        SubprocessWorker(("tuple", "wid"), payload, device="cpu")
    sub = _sub(payload)
    try:
        with pytest.raises(TypeError, match="JSON-plain"):
            sub.open_stream(("s", 1))
    finally:
        sub.close(timeout=10)


def test_tampered_payload_rejected_at_construction(payload):
    """A payload whose plan_hash does not match the plan it carries must
    fail the constructor with the child's structured PlanMismatch."""
    tampered = dict(payload, plan_hash="0" * len(payload["plan_hash"]))
    with pytest.raises(PlanMismatch):
        SubprocessWorker("evil", tampered, device="cpu", start_timeout_s=60)


# ------------------------------------------------------------ crash safety
def test_sigkill_mid_flight_resolves_every_future(payload):
    """SIGKILL with submits in flight: every future resolves within the
    sweep interval (a result or a structured WorkerDown, never a hang)
    and liveness flips without any parent-side bookkeeping."""
    sub = _sub(payload)
    try:
        sub.open_stream(0, alpha=ALPHA)
        sub.submit(_frame(0), stream_id=0).result(timeout=60)
        futs = [sub.submit(_frame(1 + t), stream_id=0) for t in range(6)]
        assert sub.healthy()
        sub.crash()  # SIGKILL the child; tell the parent nothing
        resolved = 0
        for f in futs:
            try:
                assert np.isfinite(f.result(timeout=30)).all()
            except WorkerDown:
                pass
            resolved += 1
        assert resolved == len(futs)
        t0 = time.monotonic()
        while sub.healthy() and time.monotonic() - t0 < 10.0:
            time.sleep(0.02)
        assert not sub.healthy()
        with pytest.raises(WorkerDown):
            sub.submit(_frame(99), stream_id=0).result(timeout=30)
    finally:
        sub.close(timeout=5)


def test_snapshot_restore_bit_equivalence(payload):
    """Continuation from a shipped snapshot is bit-identical to a stream
    that never failed: warm 4 frames on the child, snapshot, SIGKILL,
    restore onto a fresh in-process worker, serve frame 4, compare with an
    uninterrupted worker fed the same sequence."""
    frames = [_frame(100 + t) for t in range(5)]
    ref = _local("ref", payload)
    sub = _sub(payload)
    survivor = None
    try:
        ref.open_stream("s", alpha=ALPHA)
        sub.open_stream("s", alpha=ALPHA)
        for t in range(4):
            a = ref.submit(frames[t], stream_id="s").result(timeout=60).numpy()
            b = sub.submit(frames[t], stream_id="s").result(timeout=60)
            np.testing.assert_array_equal(a, b)
        assert sub.request_snapshot() == ["s"]
        sub.crash()
        snap = sub.carry_snapshot("s")  # parent-side store: survives death
        assert snap is not None
        assert snap.plan_hash == payload["plan_hash"]
        assert snap.frames_seen == 4
        assert isinstance(snap.carry, np.ndarray) and snap.carry.dtype == np.float32
        assert np.isfinite(snap.carry).all()

        survivor = _local("sv", payload)
        survivor.open_stream("s", alpha=ALPHA)
        assert survivor.restore_carry("s", snap)
        want = ref.submit(frames[4], stream_id="s").result(timeout=60)
        got = survivor.submit(frames[4], stream_id="s").result(timeout=60)
        assert torch.equal(got, want)
    finally:
        sub.close(timeout=5)
        ref.close(timeout=10)
        if survivor is not None:
            survivor.close(timeout=10)


# -------------------------------------------------------- transport faults
def test_dropped_submit_fails_by_sweep_never_hangs(payload):
    """An injected drop_message on a submit: the bytes vanish, the child
    never sees the frame, and the parent's sweep fails the future with
    WorkerDown after submit_timeout_s. 'Message lost' can cost latency,
    never a hang."""
    inj = FaultInjector([Fault(kind="drop_message", message="submit", times=1)])
    sub = _sub(payload, submit_timeout_s=2.0)
    try:
        sub.open_stream(0, alpha=ALPHA)
        sub.submit(_frame(0), stream_id=0).result(timeout=60)
        sub.fault_injector = inj
        fut = sub.submit(_frame(1), stream_id=0)  # this one is dropped
        with pytest.raises(WorkerDown, match="unresolved"):
            fut.result(timeout=30)
        assert inj.fired == [1]
        sub.fault_injector = None
        out = sub.submit(_frame(2), stream_id=0).result(timeout=60)
        assert np.isfinite(out).all()
    finally:
        sub.close(timeout=10)


def test_truncated_message_reconnects_and_carries_survive(payload):
    """An injected truncation desynchronizes the child's framing: the torn
    frame decodes to a structured CodecError child-side, the child
    re-dials, and the stream's warm carry survives (frames_seen keeps
    counting, no quarantine)."""
    inj = FaultInjector([Fault(kind="truncate_message", message="submit",
                               fraction=0.5, times=1)])
    # the child tears a read stalled for heartbeat_timeout_s: 1 s here
    sub = _sub(payload, heartbeat_timeout_s=1.0)
    try:
        sub.open_stream(0, alpha=ALPHA)
        sub.submit(_frame(0), stream_id=0).result(timeout=60)
        sub.fault_injector = inj
        fut = sub.submit(_frame(1), stream_id=0)  # truncated on the wire
        with pytest.raises(WorkerDown):
            fut.result(timeout=60)
        t0 = time.monotonic()
        out = None
        while time.monotonic() - t0 < 30.0:
            try:
                out = sub.submit(_frame(2), stream_id=0).result(timeout=60)
                break
            except WorkerDown:
                time.sleep(0.05)
        assert out is not None and np.isfinite(out).all()
        assert sub.reconnects >= 1
        assert sub.stats().reconnects == sub.reconnects
        assert sub.warm_streams() == [0]
        snap = sub.request_snapshot() and sub.carry_snapshot(0)
        assert snap.frames_seen == 2
        assert inj.fired == [1]
    finally:
        sub.close(timeout=10)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_stalled_heartbeats_flip_liveness_without_process_death(payload, warm):
    """A wedged child (alive, not heartbeating) goes unhealthy after
    heartbeat_timeout_s, and recovers when heartbeats resume. Warm: the
    stream's snapshots keep arriving through the window, and they do not
    count as heartbeats."""
    inj = FaultInjector([Fault(kind="delay_heartbeat", delay_s=3.0 if warm else 1.6,
                               message="heartbeat", times=1)])
    sub = _sub(payload, heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5,
               snapshot_interval_s=0.1)
    try:
        sub.open_stream(0, alpha=ALPHA)
        if warm:
            sub.submit(_frame(0), stream_id=0).result(timeout=60)
            assert sub.request_snapshot() == [0]
        sub.fault_injector = inj
        saw_unhealthy = False
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10.0:
            if not sub.healthy():
                saw_unhealthy = True
                break
            time.sleep(0.05)
        assert saw_unhealthy, "heartbeat staleness never flipped healthy()"
        assert sub._proc.poll() is None  # the process is alive: wedged != dead
        if warm:  # snapshots arrived while the child counted as down
            taken = sub.carry_snapshot(0).taken_at
            time.sleep(0.3)
            assert not sub.healthy()
            assert sub.carry_snapshot(0).taken_at > taken
        t0 = time.monotonic()
        while not sub.healthy() and time.monotonic() - t0 < 10.0:
            time.sleep(0.05)
        assert sub.healthy(), "liveness did not recover after the window"
    finally:
        sub.close(timeout=10)


# ------------------------------------------------------- the port's own
def test_bf16_child_ships_snapshots_as_bf16_words():
    """A bf16 plan's child snapshots its carries in bf16 (a CPU
    torch.bfloat16 tensor at the parent, half the fp32 bytes on the
    wire), bit for bit the carry of a local worker fed the same frames."""
    plan = BGPlan(CFG, backend="fused", temporal=True, precision="bf16", device="cpu")
    bf16 = PlanController(plan).payload()
    local = _local("loc", bf16)
    sub = _sub(bf16)
    try:
        for w in (local, sub):
            w.open_stream(0, alpha=ALPHA)
        for t in range(3):
            a = local.submit(_frame(t), stream_id=0).result(timeout=60).numpy()
            b = sub.submit(_frame(t), stream_id=0).result(timeout=60)
            np.testing.assert_array_equal(a, b)
        assert sub.request_snapshot() == [0]
        snap = sub.carry_snapshot(0)
        assert snap.carry.dtype == torch.bfloat16 and snap.frames_seen == 3
        assert torch.equal(snap.carry, local.packer.sessions[0].carry)
    finally:
        sub.close(timeout=10)
        local.close(timeout=10)


def test_child_asked_for_the_card_without_one_refuses(payload):
    """The child resolves its device from the PLAN message: asked for the
    card on a host with none, it answers ERROR and exits, and the
    constructor raises: it never serves on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    t0 = time.monotonic()
    with pytest.raises(WorkerDown, match="no CUDA device"):
        SubprocessWorker("gpu", payload, device="cuda", start_timeout_s=60)
    assert time.monotonic() - t0 < 60
