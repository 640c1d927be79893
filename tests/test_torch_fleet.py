"""The port's fleet layer (``repro_torch.fleet``): the cases of
tests/test_fleet.py on CPU workers, the cross-package cases, and the
port's own.

The load-bearing quartet, as in the JAX package:

  * ``test_affinity_invariant_1k_frames``: across 1000 frames a warm
    stream's frames land on exactly one worker and the affinity table never
    silently moves.
  * ``test_worker_kill_quarantines_exactly_victim_streams``: a worker death
    resets precisely its own streams' carries; survivors' carry tensors are
    untouched (asserted by identity), and every migration in
    ``rebalance_log`` was preceded by a quarantine.
  * ``test_mixed_plan_hash_rejected_at_construction``.
  * ``test_router_sheds_before_worker_queue_overflows``.

Everything is scheduling-order independent: the watchdog thread is
disabled (``health_interval_s=None``) and failures are injected or
triggered synchronously. Every wait is bounded.

Across the packages, on numpy inputs from a seed: pinned payloads hash
alike and load both ways; a port worker and a JAX worker agree on 2 streams
x 6 frames at alpha 0.6 at the temporal tolerances (quantized >= 99.5 %
exact and <= 1 LSB apart, carries atol 2e-2 / rtol 1e-3,
tests/test_temporal_fused.py:118-123), each pack holding both streams (the
reference's own pack-composition case is red); a JAX worker's snapshot
restores into a port worker. The JAX package is imported in fixtures.

``test_workers_share_one_compiled_executable`` is, in the port, one
executable per equal plan (CPU) and one loaded library per kernel source
across a process's workers (a ``gpu`` case).
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import BGConfig
from repro_torch.fleet import (
    FleetRouter,
    FleetSaturated,
    FleetWatchdog,
    LocalWorker,
    PlanController,
    PlanMismatch,
)
from repro_torch.fleet import codec
from repro_torch.kernels import _wrap
from repro_torch.plan import BGPlan, plan_for
from repro_torch.plan_cache import CACHE_ENV_VAR, PlanCache
from repro_torch.reliability import Fault, FaultInjector, FaultPlan
from repro_torch.serving import EngineStats
from repro_torch.sharding import BatchMesh

CFG = BGConfig(r=4, sigma_s=4.0, sigma_r=60.0)
H, W = 24, 32
ALPHA = 0.6
WAIT_S = 60.0  # every future's bounded wait


@pytest.fixture(autouse=True)
def _hermetic_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV_VAR, str(tmp_path / "plan_cache.json"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _controller(streams_per_worker=4, cfg=CFG, **kw):
    return PlanController(
        cfg=cfg, height=H, width=W,
        streams_per_worker=streams_per_worker, temporal=True,
        sharded=False, device="cpu", **kw,
    )


def _fleet(n_workers=2, **kw):
    kw.setdefault("health_interval_s", None)  # deterministic: no poller
    kw.setdefault("worker_kwargs", dict(device="cpu", max_batch=8, batch_window_ms=1.0))
    kw.setdefault("controller", _controller())
    return FleetRouter(n_workers=n_workers, **kw)


def _frame(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 255.0, size=(h, w)).astype(np.float32)


def _finite(fut) -> bool:
    return bool(torch.isfinite(torch.as_tensor(fut.result(timeout=WAIT_S))).all())


# --------------------------------------------------------------- affinity
def test_affinity_invariant_1k_frames():
    """1000 frames over 8 warm streams on 2 workers: every stream's frames
    land on exactly the worker its affinity entry names, and nothing ever
    migrates (no failures -> empty rebalance_log)."""
    n_streams, rounds = 8, 125
    frames = [_frame(s) for s in range(n_streams)]
    with _fleet(n_workers=2) as router:
        pins = {s: router.open_stream(s, alpha=ALPHA) for s in range(n_streams)}
        assert set(pins.values()) <= {0, 1}
        for t in range(rounds):
            futs = [router.submit(frames[s], stream_id=s) for s in range(n_streams)]
            for f in futs:
                assert _finite(f)
            # the pin never moves while the stream is warm
            assert {s: router.stream_worker(s) for s in range(n_streams)} == pins
        for s in range(n_streams):
            served_on = {
                w.wid for w in router.workers if w.streams_served.get(s, 0) > 0
            }
            assert served_on == {pins[s]}, (s, served_on, pins[s])
            assert router.workers[pins[s]].streams_served[s] == rounds
        assert router.rebalance_log == []
        assert router.rebalanced_streams == 0
        st = router.stats()
        assert st.merged.completed == n_streams * rounds
        assert st.merged.failed == 0


def test_temporal_fleet_requires_stream_id():
    with _fleet(n_workers=2) as router:
        with pytest.raises(ValueError, match="stream_id"):
            router.submit(_frame(0))
        with pytest.raises(KeyError):
            router.submit(_frame(0), stream_id="never-opened")


# ------------------------------------------------------ failure containment
def test_worker_kill_quarantines_exactly_victim_streams():
    """Killing one worker resets exactly its streams (cold restart on the
    survivor); surviving streams keep their carry tensors untouched."""
    n_streams = 6
    frames = [_frame(100 + s) for s in range(n_streams)]
    with _fleet(n_workers=2) as router:
        pins = {s: router.open_stream(s, alpha=ALPHA) for s in range(n_streams)}
        for _ in range(2):
            for f in [router.submit(frames[s], stream_id=s) for s in range(n_streams)]:
                f.result(timeout=WAIT_S)
        victim_wid = pins[0]
        survivor = next(w for w in router.workers if w.wid != victim_wid)
        victims = sorted(s for s, w in pins.items() if w == victim_wid)
        keepers = sorted(s for s, w in pins.items() if w != victim_wid)
        assert victims and keepers, "rendezvous split both ways"
        kept_carries = {s: survivor.packer.sessions[s].carry for s in keepers}
        assert all(c is not None for c in kept_carries.values())

        moved = router.fail_worker(victim_wid)

        assert sorted(s for s, _ in moved) == victims
        assert router.quarantined_streams == len(victims)
        assert router.rebalanced_streams == len(victims)
        assert sorted(s for s, _, _ in router.rebalance_log) == victims
        for s, old, new in router.rebalance_log:
            assert old == victim_wid and new == survivor.wid
        for s in victims:
            assert router.stream_worker(s) == survivor.wid
            assert survivor.packer.sessions[s].carry is None
        for s in keepers:
            assert survivor.packer.sessions[s].carry is kept_carries[s]
        for f in [router.submit(frames[s], stream_id=s) for s in range(n_streams)]:
            assert _finite(f)
        assert router.workers_alive == 1
        assert router.fail_worker(victim_wid) == []
        assert router.workers_lost == 1


def test_submit_path_detects_dead_worker_and_fails_over():
    """A worker killed WITHOUT telling the router (chaos hook) is noticed
    by the next submit, evacuated, and the frame retried on the survivor."""
    with _fleet(n_workers=2) as router:
        pins = {s: router.open_stream(s, alpha=ALPHA) for s in range(4)}
        for f in [router.submit(_frame(s), stream_id=s) for s in range(4)]:
            f.result(timeout=WAIT_S)
        victim_wid = pins[0]
        router.kill_worker(victim_wid)  # router not told
        for s in range(4):
            assert _finite(router.submit(_frame(s), stream_id=s))
        assert router.is_dead(victim_wid)
        assert router.workers_lost == 1
        survivor_wid = next(w.wid for w in router.workers if w.wid != victim_wid)
        assert all(router.stream_worker(s) == survivor_wid for s in range(4))


def test_watchdog_detects_silent_death():
    """The watchdog's poll (run synchronously here) notices a dead worker
    with no traffic flowing and triggers the same evacuation."""
    with _fleet(n_workers=2) as router:
        pins = {s: router.open_stream(s, alpha=ALPHA) for s in range(4)}
        for f in [router.submit(_frame(s), stream_id=s) for s in range(4)]:
            f.result(timeout=WAIT_S)
        victim_wid = pins[0]
        router.kill_worker(victim_wid)
        dog = FleetWatchdog(router, interval_s=60.0)  # won't tick on its own
        try:
            dog.poll()
        finally:
            dog.stop()
        assert router.is_dead(victim_wid)
        assert sorted(s for s, _, _ in router.rebalance_log) == sorted(
            s for s, w in pins.items() if w == victim_wid
        )


# --------------------------------------------------------- plan distribution
def test_mixed_plan_hash_rejected_at_construction():
    ctrl_a = _controller()
    ctrl_b = _controller(cfg=BGConfig(r=8, sigma_s=4.0, sigma_r=60.0))
    assert ctrl_a.plan_hash != ctrl_b.plan_hash
    w0 = LocalWorker(0, ctrl_a.payload(), device="cpu")
    w1 = LocalWorker(1, ctrl_b.payload(), device="cpu")
    try:
        with pytest.raises(PlanMismatch, match="mixed-plan"):
            FleetRouter(workers=[w0, w1], health_interval_s=None)
        with pytest.raises(PlanMismatch):
            ctrl_a.verify([w0, w1])
    finally:
        w0.close(timeout=5.0)
        w1.close(timeout=5.0)


def test_worker_refuses_tampered_payload():
    payload = _controller().payload()
    payload["plan_hash"] = "0" * 16
    with pytest.raises(PlanMismatch, match="rebuilt plan hashes"):
        LocalWorker(0, payload, device="cpu")


def test_workers_share_one_compiled_executable():
    """Equal plans rebuilt from one payload share one executable (the
    port's ``_plan_executable`` is keyed on plan equality): plan
    distribution costs one build, not N."""
    with _fleet(n_workers=3) as router:
        w0, w1, w2 = router.workers
        assert w0.plan == w1.plan == w2.plan
        assert w0.plan.executable() is w1.plan.executable()
        assert w1.plan.executable() is w2.plan.executable()


def test_kernel_sources_cover_every_kernel_backend():
    """``load_kernels`` loads the sources of its plan's ladder: every
    kernel backend names its sources, and together they are every source
    of the port."""
    from repro_torch.fleet import worker as worker_mod
    from repro_torch.kernels import _build
    from repro_torch.plan import _KERNEL_BACKENDS

    srcs = worker_mod._BACKEND_SOURCES
    assert sorted(srcs) == sorted(_KERNEL_BACKENDS)
    assert sorted(n for names in srcs.values() for n in names) == sorted(_build.SOURCES)


@pytest.mark.gpu
def test_workers_share_one_loaded_library_on_card(cuda):
    """On the card, two workers of one process built from one payload call
    the same loaded library per kernel source: the first worker's kernel
    load is the fleet's only one, and their launches count apart."""
    from repro_torch.kernels import _build

    payload = PlanController(
        cfg=CFG, height=H, width=W, streams_per_worker=2, temporal=True, device=cuda,
    ).payload()
    w0 = LocalWorker(0, payload, device=cuda, max_batch=2, batch_window_ms=1.0)
    w1 = LocalWorker(1, payload, device=cuda, max_batch=2, batch_window_ms=1.0)
    try:
        assert w0.load_kernels() == ("bg_fused",)  # the temporal plan's B2 only
        lib = _build._libs["bg_fused"]
        assert w1.load_kernels() == ("bg_fused",) and _build._libs["bg_fused"] is lib
        for w in (w0, w1):
            w.open_stream("s", alpha=ALPHA)
        for t in range(3):
            futs = [w.submit(_frame(t), stream_id="s") for w in (w0, w1)]
            a, b = (f.result(timeout=WAIT_S) for f in futs)
            assert a.is_cuda and torch.equal(a, b)
        assert _build._libs["bg_fused"] is lib
        for w in (w0, w1):
            assert w.launches() == {"bg_fused.temporal_launches": w.stats().dispatches}
    finally:
        w0.close(timeout=10.0)
        w1.close(timeout=10.0)


# ----------------------------------------- snapshot-restore failover
class _SnapshotTamperer(LocalWorker):
    """A snapshot-enabled LocalWorker whose snapshots can be doctored: the
    deterministic lever for the router's reject paths (staleness, foreign
    hash, poisoned carry) without a subprocess or a clock."""

    def __init__(self, *args, age_offset=0.0, hash_override=None,
                 poison=False, **kw):
        kw.setdefault("snapshots", True)
        super().__init__(*args, **kw)
        self.age_offset = age_offset
        self.hash_override = hash_override
        self.poison = poison

    def carry_snapshot(self, sid):
        snap = super().carry_snapshot(sid)
        if snap is None:
            return None
        if self.hash_override is not None:
            snap = dataclasses.replace(snap, plan_hash=self.hash_override)
        if self.poison:
            snap = dataclasses.replace(snap, carry=np.full_like(snap.carry, np.nan))
        return dataclasses.replace(snap, taken_at=snap.taken_at - self.age_offset)


def _warmed_snapshot_fleet(worker_cls=None, n_streams=6, router_kw=None,
                           **worker_extra):
    """Two snapshot-enabled workers (worker 0 optionally a tamperer), all
    streams warmed twice. Returns (router, pins)."""
    payload = _controller().payload()
    kw = dict(device="cpu", max_batch=8, batch_window_ms=1.0, snapshots=True)
    w0 = (worker_cls or LocalWorker)(0, payload, **kw, **worker_extra)
    w1 = LocalWorker(1, payload, **kw)
    router = FleetRouter(workers=[w0, w1], health_interval_s=None,
                         **(router_kw or {}))
    pins = {s: router.open_stream(s, alpha=ALPHA) for s in range(n_streams)}
    for _ in range(2):
        for f in [router.submit(_frame(200 + s), stream_id=s) for s in range(n_streams)]:
            f.result(timeout=WAIT_S)
    return router, pins


def test_fail_worker_restores_warm_carries_bit_exact():
    """With snapshots enabled, a worker death restores its warm streams'
    carries bit-for-bit onto the survivor (zero cold quarantines) and stays
    idempotent across the snapshot path."""
    router, pins = _warmed_snapshot_fleet()
    with router:
        victim_wid = pins[0]
        victim = router.workers[victim_wid]
        survivor = next(w for w in router.workers if w.wid != victim_wid)
        victims = sorted(s for s, w in pins.items() if w == victim_wid)
        assert victims, "rendezvous gave worker 0 no streams"
        want = {s: victim.packer.sessions[s].carry.clone() for s in victims}
        seen = {s: victim.packer.sessions[s].frames_seen for s in victims}

        moved = router.fail_worker(victim_wid)

        assert sorted(s for s, _ in moved) == victims
        assert router.restores == len(victims)
        assert router.quarantined_streams == 0
        assert router.rebalanced_streams == len(victims)
        assert len(router.restore_staleness_samples) == len(victims)
        assert all(a < 5.0 for a in router.restore_staleness_samples)
        for s in victims:
            sess = survivor.packer.sessions[s]
            assert torch.equal(sess.carry, want[s])
            assert sess.frames_seen == seen[s]
        for s in victims:
            assert _finite(router.submit(_frame(300 + s), stream_id=s))
        st = router.stats()
        assert st.restores == len(victims)
        assert st.quarantined_streams == 0
        assert st.restore_staleness_p99 >= 0.0
        assert router.fail_worker(victim_wid) == []
        assert router.restores == len(victims)
        assert router.workers_lost == 1


def test_stale_snapshot_falls_back_to_cold_quarantine():
    router, pins = _warmed_snapshot_fleet(
        worker_cls=_SnapshotTamperer, age_offset=60.0,
        router_kw=dict(restore_max_age_s=5.0),
    )
    with router:
        victims = sorted(s for s, w in pins.items() if w == 0)
        survivor = router.workers[1]
        router.fail_worker(0)
        assert router.restores == 0
        assert router.quarantined_streams == len(victims)
        for s in victims:
            assert survivor.packer.sessions[s].carry is None


def test_foreign_hash_snapshot_never_restored():
    router, pins = _warmed_snapshot_fleet(
        worker_cls=_SnapshotTamperer, hash_override="f" * 16,
    )
    with router:
        victims = sorted(s for s, w in pins.items() if w == 0)
        router.fail_worker(0)
        assert router.restores == 0
        assert router.quarantined_streams == len(victims)


def test_failed_restore_is_all_or_nothing():
    """A snapshot that fails validation mid-restore (poisoned NaN carry)
    must leave the survivor's stream exactly as open_stream made it: cold,
    zero frames_seen, never half-restored."""
    router, pins = _warmed_snapshot_fleet(worker_cls=_SnapshotTamperer, poison=True)
    with router:
        victims = sorted(s for s, w in pins.items() if w == 0)
        survivor = router.workers[1]
        router.fail_worker(0)
        assert router.restores == 0
        assert router.quarantined_streams == len(victims)
        for s in victims:
            sess = survivor.packer.sessions[s]
            assert sess.carry is None
            assert sess.frames_seen == 0
            assert sess.alpha == ALPHA
        for s in victims:
            assert _finite(router.submit(_frame(400 + s), stream_id=s))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_snapshot_through_the_wire_restores_bit_exact(precision):
    """A snapshot in the plan's storage type (float32 numpy; a CPU bf16
    tensor, half the bytes) crosses the codec and restores onto another
    worker bit for bit, and both workers then serve the same next frame."""
    plan = BGPlan(CFG, backend="fused", temporal=True, precision=precision, device="cpu")
    payload = PlanController(plan).payload()
    a = LocalWorker("a", payload, device="cpu", snapshots=True, batch_window_ms=1.0)
    b = LocalWorker("b", payload, device="cpu", batch_window_ms=1.0)
    try:
        for w in (a, b):
            w.open_stream("s", alpha=ALPHA)
        for t in range(3):
            a.submit(_frame(t), stream_id="s").result(timeout=WAIT_S)
        snap = a.carry_snapshot("s")
        carry = a.packer.sessions["s"].carry
        hdr, data = codec.array_header(snap.carry), codec.array_bytes(snap.carry)
        assert hdr["dtype"] == ("bfloat16" if precision == "bf16" else "<f4")
        assert len(data) == carry.numel() * (2 if precision == "bf16" else 4)
        snap = dataclasses.replace(snap, carry=codec.decode_array(hdr, data))
        assert b.restore_carry("s", snap)
        assert torch.equal(b.packer.sessions["s"].carry, carry)
        assert b.packer.sessions["s"].frames_seen == 3
        fa, fb = (w.submit(_frame(9), stream_id="s") for w in (a, b))
        assert torch.equal(fa.result(timeout=WAIT_S), fb.result(timeout=WAIT_S))
    finally:
        a.close(timeout=10.0)
        b.close(timeout=10.0)


# ---------------------------------------------------------- rolling restart
def test_replace_worker_requires_death_and_matching_identity():
    with _fleet(n_workers=2) as router:
        with pytest.raises(ValueError, match="not dead"):
            router.replace_worker(0)
        with pytest.raises(KeyError):
            router.replace_worker("no-such-worker")
        router.fail_worker(0)
        fresh = router.replace_worker(0)
        assert fresh.wid == 0 and fresh.plan_hash == router.plan_hash
        assert router.worker_restarts == 1
        assert router.workers_alive == 2
        assert not router.is_dead(0)
        assert router.workers[0] is fresh


def test_replace_worker_returns_slot_to_rotation():
    """After replacement, new streams place onto the fresh slot by
    rendezvous; existing pins stay where failover put them."""
    with _fleet(n_workers=2) as router:
        pins = {s: router.open_stream(s, alpha=ALPHA) for s in range(6)}
        for f in [router.submit(_frame(s), stream_id=s) for s in range(6)]:
            f.result(timeout=WAIT_S)
        router.fail_worker(0)
        router.replace_worker(0)
        for s in range(6):
            assert router.stream_worker(s) == 1
        new_pins = {s: router.open_stream(s, alpha=ALPHA) for s in range(6, 30)}
        assert set(new_pins.values()) == {0, 1}
        for s in list(new_pins) + list(pins):
            assert _finite(router.submit(_frame(s), stream_id=s))


def test_replace_worker_rejects_wrong_wid_and_foreign_plan():
    payload = _controller().payload()
    with _fleet(n_workers=2) as router:
        router.fail_worker(1)
        wrong_wid = LocalWorker(99, payload, device="cpu")
        try:
            with pytest.raises(ValueError, match="does not match slot"):
                router.replace_worker(1, worker=wrong_wid)
        finally:
            wrong_wid.close(timeout=5.0)
        foreign = LocalWorker(
            1, _controller(cfg=BGConfig(r=8, sigma_s=4.0, sigma_r=60.0)).payload(), device="cpu"
        )
        try:
            with pytest.raises(PlanMismatch):
                router.replace_worker(1, worker=foreign)
        finally:
            foreign.close(timeout=5.0)
        assert router.worker_restarts == 0
        assert router.is_dead(1)
        router.replace_worker(1)
        assert router.worker_restarts == 1


def test_explicit_workers_router_has_no_factory():
    payload = _controller().payload()
    w0 = LocalWorker(0, payload, device="cpu")
    w1 = LocalWorker(1, payload, device="cpu")
    router = FleetRouter(workers=[w0, w1], health_interval_s=None)
    with router:
        router.fail_worker(0)
        with pytest.raises(ValueError, match="factory"):
            router.replace_worker(0)
        w0b = LocalWorker(0, payload, device="cpu")
        assert router.replace_worker(0, worker=w0b) is w0b


def test_controller_bless_roundtrip(tmp_path):
    """bless() writes the fleet's plan into a cache file that a later
    plan_for resolves from (provenance flips to the cache)."""
    path = str(tmp_path / "blessed.json")
    ctrl = _controller(streams_per_worker=4)
    key = ctrl.bless(path, measured_us=123.0)
    pc = PlanCache(path)
    ent = pc.lookup(key)
    assert ent is not None and ent["source"] == "controller"
    assert ent["plan_hash"] == ctrl.plan_hash
    resolved = plan_for(CFG, H, W, n_frames=4, temporal=True, sharded=False, cache=pc,
                        device="cpu")
    assert resolved.plan_hash() == ctrl.plan_hash
    assert resolved.provenance.startswith("cache")


# ------------------------------------------------------------- backpressure
def test_router_sheds_before_worker_queue_overflows():
    """With a wedged worker, the router sheds at its own (small) bound with
    structured FleetSaturated; the worker's far larger request queue never
    fills, so submit can never wedge or raise raw queue.Full."""
    engine_max_queue = 64
    bound = 4
    inj = FaultInjector(FaultPlan(faults=(
        Fault(kind="hang_completion", delay_s=0.25, times=None),
    )))
    router = FleetRouter(
        controller=_controller(streams_per_worker=1),
        n_workers=1,
        max_worker_queue=bound,
        health_interval_s=None,
        worker_kwargs=dict(
            device="cpu",
            max_batch=1,
            batch_window_ms=0.0,
            max_queue=engine_max_queue,
            fault_injector=inj,
            engine_kwargs=dict(max_inflight=1),
        ),
    )
    try:
        router.open_stream(0, alpha=ALPHA)
        worker = router.workers[0]
        frame = _frame(7)
        accepted, shed = [], 0
        for _ in range(5 * bound):
            try:
                accepted.append(router.submit(frame, stream_id=0, block=False))
            except FleetSaturated as exc:
                shed += 1
                assert exc.wid == worker.wid
                assert exc.limit == bound and exc.depth >= bound
            assert worker.queue_depth() <= bound + 1 < engine_max_queue
        assert shed > 0 and router.router_shed == shed
        assert len(accepted) >= bound
        assert router.stats().router_shed == shed
        for f in accepted:
            assert _finite(f)
    finally:
        router.close()


# ---------------------------------------------------------------- telemetry
def test_engine_stats_merge_exact_percentiles():
    """Fleet percentiles come from the union of the latency reservoirs:
    exactly the single-engine estimator applied to the concatenation, not
    an average of per-engine percentiles."""
    a = EngineStats(
        submitted=10, completed=10, dispatches=5, queue_depth=1,
        inflight_depth=0, deadline_misses=1, mean_batch=2.0,
        latency_ms_p50=2.0, latency_ms_p99=4.0,
        latency_samples=(1.0, 2.0, 3.0, 4.0),
    )
    b = EngineStats(
        submitted=6, completed=6, dispatches=3, queue_depth=0,
        inflight_depth=2, deadline_misses=0, mean_batch=1.0,
        latency_ms_p50=100.0, latency_ms_p99=400.0, failed=2,
        carry_resets=3, reconnects=2, latency_samples=(100.0, 200.0, 400.0),
    )
    m = EngineStats.merge([a, b, None])
    union = sorted(a.latency_samples + b.latency_samples)
    assert m.latency_samples == tuple(union)
    n = len(union)
    assert m.latency_ms_p50 == union[min(int(0.50 * n), n - 1)]
    assert m.latency_ms_p99 == union[min(int(0.99 * n), n - 1)]
    assert m.latency_ms_p99 == 400.0
    assert m.submitted == 16 and m.completed == 16 and m.failed == 2
    assert m.dispatches == 8 and m.deadline_misses == 1
    assert m.carry_resets == 3 and m.reconnects == 2
    assert m.mean_batch == pytest.approx((2.0 * 5 + 1.0 * 3) / 8)
    empty = EngineStats.merge([])
    assert empty.completed == 0 and empty.latency_ms_p99 == 0.0
    bare = EngineStats.merge([
        EngineStats(4, 4, 2, 0, 0, 0, 2.0, 10.0, 20.0),
        EngineStats(12, 12, 6, 0, 0, 0, 2.0, 30.0, 40.0),
    ])
    assert bare.latency_ms_p50 == pytest.approx((10 * 4 + 30 * 12) / 16)
    assert bare.latency_ms_p99 == pytest.approx((20 * 4 + 40 * 12) / 16)


def test_fleet_stats_rollup():
    with _fleet(n_workers=2) as router:
        for s in range(4):
            router.open_stream(s, alpha=ALPHA)
        for _ in range(3):
            for f in [router.submit(_frame(s), stream_id=s) for s in range(4)]:
                f.result(timeout=WAIT_S)
        st = router.stats()
        assert st.workers == 2 and st.workers_alive == 2
        assert st.streams == 4 and st.plan_hash == router.plan_hash
        assert st.merged.completed == 12
        assert st.merged.completed == sum(p.completed for p in st.per_worker)
        assert st.deadline_miss_rate == 0.0
        d = st.as_dict()
        assert d["merged_completed"] == 12
        assert "merged_latency_samples" not in d
        assert d["max_queue_depth"] == max(st.queue_depths)
        assert all(w.launches() == {} for w in router.workers)  # the CPU launches none


# ------------------------------------------------------- the port's own
def test_launch_counters_exact_under_threads():
    """The wrappers' launch counters and the engines' per-thread tallies
    stay exact when many threads launch at once (a lost update would show
    as a short count): 16 threads x 2000 counts, a tiny switch interval."""
    def fake():
        pass

    fake.launches = 0
    n_threads, n = 16, 2000
    tallies = [{} for _ in range(n_threads)]

    def run(i):
        _wrap.tally_launches(tallies[i])
        for _ in range(n):
            _wrap.count(fake, "launches")
        _wrap.tally_launches(None)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert fake.launches == n_threads * n
    assert all(_wrap.read_tally(t) == {"fake.launches": n} for t in tallies)


def test_local_worker_runs_on_the_card_unless_asked_for_cpu():
    """``device=None`` is the card: with no card the worker raises instead
    of serving on the CPU. A mesh payload (ported now) binds this host's
    cards with ``mesh="auto"`` and raises ``ValueError`` when it has too
    few; an explicit mesh rebinds it and the worker serves through it."""
    payload = _controller().payload()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LocalWorker(0, payload)
    plan2 = dict(payload["plan"], mesh_size=2)
    meshed = dict(payload, plan=plan2, plan_hash=BGPlan.from_json(plan2, mesh=BatchMesh(("cpu",) * 2)).plan_hash())
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="2-device mesh"):
            LocalWorker(0, meshed, device="cpu")
    w = LocalWorker(0, meshed, mesh=BatchMesh(("cpu",) * 2))
    try:
        assert (w.plan.mesh_size, w.plan_hash) == (2, meshed["plan_hash"])
        w.open_stream(0, alpha=ALPHA)
        frame = np.full((H, W), 100.0, np.float32)
        out = w.submit(frame, stream_id=0).result(timeout=WAIT_S)
        assert tuple(out.shape) == (H, W) and out.device.type == "cpu"
    finally:
        w.close()


# ----------------------------------------------------------- cross-package
@pytest.fixture
def jx():
    """The JAX package's fleet, plan and config (imported here, not at
    module level, so the card's host can collect this file)."""
    pytest.importorskip("jax")
    import repro.core as jcore
    import repro.fleet as jfleet
    import repro.plan as jplan

    return jfleet, jplan, jcore


def _pinned_payloads(jx, **pins):
    jfleet, jplan, jcore = jx
    jcfg = jcore.BGConfig(r=CFG.r, sigma_s=CFG.sigma_s, sigma_r=CFG.sigma_r)
    jctrl = jfleet.PlanController(plan=jplan.BGPlan(cfg=jcfg, temporal=True, **pins))
    pctrl = PlanController(plan=BGPlan(cfg=CFG, temporal=True, device="cpu", **pins))
    return jctrl.payload(), pctrl.payload()


@pytest.mark.parametrize("pins", [dict(backend="fused"), dict(backend="fused", batch_tile=2),
                                  dict(backend="fused", precision="bf16")],
                         ids=["fused", "fused-bt2", "fused-bf16"])
def test_pinned_payloads_load_across_packages_with_one_hash(jx, pins):
    """A JAX controller's payload for a pinned plan builds a port worker
    with the same plan_hash, and a port payload a JAX worker."""
    jfleet = jx[0]
    jpay, ppay = _pinned_payloads(jx, **pins)
    assert jpay["plan_hash"] == ppay["plan_hash"]
    pw = LocalWorker(0, jpay, device="cpu")
    jw = jfleet.LocalWorker(1, ppay)
    try:
        assert pw.plan_hash == jw.plan_hash == jpay["plan_hash"]
        assert pw.plan.to_json()["precision"] == pins.get("precision", "fp32")
    finally:
        pw.close(timeout=10.0)
        jw.close(timeout=10.0)


def _quantized_close(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    d = np.abs(a - b)
    assert (d == 0).mean() >= 0.995 and d.max() <= 1.0, ((d == 0).mean(), d.max())


def _carry_close(port_carry, jax_carry):
    np.testing.assert_allclose(
        port_carry.float().cpu().numpy(), np.asarray(jax_carry, np.float32), atol=2e-2, rtol=1e-3
    )


def _serve_pairs(workers, frames, sids):
    """Each frame t of every stream to every worker, both streams' frames
    submitted together (one pack per round); returns outputs per worker."""
    outs = [[] for _ in workers]
    for t in range(len(frames[sids[0]])):
        futs = [[w.submit(frames[s][t], stream_id=s) for s in sids] for w in workers]
        for i, fs in enumerate(futs):
            outs[i].append([f.result(timeout=WAIT_S) for f in fs])
    return outs


def test_port_worker_agrees_with_jax_worker(jx):
    """2 streams x 6 frames at alpha 0.6 through a port worker and a JAX
    worker built from one pinned payload: quantized output >= 99.5 % exact
    and <= 1 LSB apart, carries within atol 2e-2 / rtol 1e-3."""
    jfleet = jx[0]
    jpay, _ = _pinned_payloads(jx, backend="fused")
    sids = ["a", "b"]
    frames = {s: [_frame(50 * i + t, 37, 53) for t in range(6)] for i, s in enumerate(sids)}
    kw = dict(max_batch=2, batch_window_ms=200.0, snapshots=True)
    pw = LocalWorker("p", jpay, device="cpu", **kw)
    jw = jfleet.LocalWorker("j", jpay, **kw)
    try:
        for w in (pw, jw):
            for s in sids:
                w.open_stream(s, alpha=ALPHA)
        p_out, j_out = _serve_pairs([pw, jw], frames, sids)
        for pt, jt in zip(p_out, j_out):
            for a, b in zip(pt, jt):
                _quantized_close(a.numpy(), b)
        for s in sids:
            ps, js = pw.carry_snapshot(s), jw.carry_snapshot(s)
            assert ps.frames_seen == js.frames_seen == 6
            _carry_close(torch.as_tensor(ps.carry), js.carry)
        assert pw.stats().mean_batch == 2.0  # every pack held both streams
    finally:
        pw.close(timeout=10.0)
        jw.close(timeout=10.0)


def test_jax_snapshot_restores_into_port_worker(jx):
    """A JAX worker's CarrySnapshot (numpy, shipped through the JAX codec)
    restores into a port worker, and the next frame agrees with the JAX
    worker's at the temporal tolerances."""
    jfleet = jx[0]
    from repro.fleet import codec as jcodec

    jpay, _ = _pinned_payloads(jx, backend="fused")
    frames = [_frame(900 + t, 37, 53) for t in range(5)]
    jw = jfleet.LocalWorker("j", jpay, max_batch=1, snapshots=True)
    pw = LocalWorker("p", jpay, device="cpu", max_batch=1)
    try:
        jw.open_stream(0, alpha=ALPHA)
        pw.open_stream(0, alpha=ALPHA)
        for t in range(4):
            jw.submit(frames[t], stream_id=0).result(timeout=WAIT_S)
        jsnap = jw.carry_snapshot(0)
        name, hdr, data = codec.decode(jcodec.encode(
            "snapshot", dict(jcodec.array_header(jsnap.carry), sid=0), jsnap.carry.tobytes()))
        snap = dataclasses.replace(jsnap, carry=codec.decode_array(hdr, data))
        assert pw.restore_carry(0, snap)
        assert pw.packer.sessions[0].frames_seen == 4
        _carry_close(pw.packer.sessions[0].carry, jsnap.carry)
        want = jw.submit(frames[4], stream_id=0).result(timeout=WAIT_S)
        got = pw.submit(frames[4], stream_id=0).result(timeout=WAIT_S)
        _quantized_close(got.numpy(), want)
        _carry_close(pw.packer.sessions[0].carry, jw.carry_snapshot(0).carry)
    finally:
        jw.close(timeout=10.0)
        pw.close(timeout=10.0)
