"""The port's reliability layer (``repro_torch.reliability`` and the guarded
``AsyncFrameEngine``): the cases of tests/test_reliability.py on CPU plans,
plus the port's own.

Fault injection, admission, retry and fallback, the breakers, carry
quarantine, the watchdog (transient and persistent), shedding and close run
as in the JAX package. Added here: one ``FaultPlan`` and seed corrupt the
same pixels in both packages, and a kernel build or launch error is
re-raised at once, never retried and never answered by a lower rung.

The chaos soak keeps its structural half on the CPU (every future resolves,
no corrupted frame is served, the schedule is absorbed as counted); its
wall-clock half, recovery at >= 0.8x the clean throughput, is a ``gpu``
case, on the card. The watchdog budgets scale with the host's load.
The JAX package is imported inside fixtures, so the card's host (no JAX)
can collect this file.
"""
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.core import BGConfig
from repro_torch.data import synthetic_video_np
from repro_torch.plan import BGPlan, plan_for, set_dispatch_hook
from repro_torch.reliability import (
    AdmissionError,
    AllBackendsFailed,
    CircuitBreaker,
    DeadlineExceeded,
    EngineClosed,
    EngineTimeout,
    Fault,
    FaultInjector,
    FaultPlan,
    GuardedDispatch,
    InjectedFault,
    KernelBuildError,
    KernelLaunchError,
    NonFiniteOutput,
    RetryPolicy,
    validate_frame,
)
from repro_torch.serving import AsyncFrameEngine
from repro_torch.video import MultiStreamPacker

CFG = BGConfig(r=4, sigma_s=4.0, sigma_r=60.0)
CPU = torch.device("cpu")


@pytest.fixture
def jx():
    """The JAX package's reliability layer (imported here, not at module
    level, so the card's host can collect this file)."""
    pytest.importorskip("jax")
    import repro.reliability as jrel

    return jrel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _relax() -> float:
    """Watchdog and hang budgets scale with the host's load (never below 1)."""
    try:
        return max(1.0, os.getloadavg()[0] / max(os.cpu_count() or 1, 1))
    except (AttributeError, OSError):
        return 1.0


def _frames(n, h=32, w=48, seed=0):
    vid = synthetic_video_np(seed, n, h, w, motion=1.0)
    noise = np.random.default_rng(seed + 77).normal(0.0, 30.0, vid.shape)
    return list(np.clip(np.floor(vid + noise + 0.5), 0.0, 255.0).astype(np.float32))


def _engine(**kw):
    kw.setdefault("device", "cpu")
    return AsyncFrameEngine(CFG, **kw)


def _finite(t) -> bool:
    return bool(torch.isfinite(torch.as_tensor(t)).all())


# --------------------------------------------------------------- fault layer
def test_fault_injection_is_deterministic():
    plan = FaultPlan(
        faults=(Fault(kind="corrupt_frame", stream_id="a", frame_index=1, fraction=0.25),
                Fault(kind="raise_dispatch", dispatch=2)),
        seed=42,
    )
    frame = _frames(1)[0]

    def run_once():
        inj = FaultInjector(plan)
        out0 = inj.corrupt_frame(frame, "a")  # index 0: no match
        out1 = inj.corrupt_frame(frame, "a")  # index 1: corrupted
        clean_b = inj.corrupt_frame(frame, "b")  # another stream
        assert inj.on_dispatch("fused") == 0
        assert inj.on_dispatch("fused") == 1
        with pytest.raises(InjectedFault) as exc:
            inj.on_dispatch("fused")
        assert exc.value.dispatch == 2
        assert inj.on_dispatch("fused") == 3  # times=1: fired out
        return out0, out1, clean_b, list(inj.log)

    o0a, o1a, cba, loga = run_once()
    o0b, o1b, cbb, logb = run_once()
    np.testing.assert_array_equal(o0a, frame)
    np.testing.assert_array_equal(cba, frame)
    assert np.isnan(o1a).any() and not np.isnan(frame).any()
    np.testing.assert_array_equal(o1a, o1b)
    assert loga == logb
    assert np.isnan(o1a).sum() == max(1, round(0.25 * frame.size))


def test_same_fault_plan_corrupts_the_same_pixels_as_jax(jx):
    """One numpy RNG in both packages: the same plan and seed hit the same
    pixels, fire in the same order and log the same events."""
    faults = ((Fault("corrupt_frame", stream_id=3, fraction=0.1, mode="inf", times=2),
               Fault("corrupt_frame", frame_index=2, fraction=0.03)),
              (jx.Fault("corrupt_frame", stream_id=3, fraction=0.1, mode="inf", times=2),
               jx.Fault("corrupt_frame", frame_index=2, fraction=0.03)))
    mine = FaultInjector(FaultPlan(faults[0], seed=7))
    theirs = jx.FaultInjector(jx.FaultPlan(faults[1], seed=7))
    frames = _frames(4, seed=3)
    for t, f in enumerate(frames):
        for sid in (3, 5):
            a = np.asarray(mine.corrupt_frame(f, sid))
            b = np.asarray(theirs.corrupt_frame(f, sid))
            np.testing.assert_array_equal(a, b)
    assert mine.log == theirs.log and mine.fired == theirs.fired == [2, 1]
    # the same kinds validate alike, the transport kinds included
    assert FaultInjector.__module__ != jx.FaultInjector.__module__
    from repro_torch.reliability import FAULT_KINDS

    assert FAULT_KINDS == jx.FAULT_KINDS


def test_fault_validation():
    with pytest.raises(ValueError):
        Fault(kind="set_on_fire")
    with pytest.raises(ValueError):
        Fault(kind="corrupt_frame", mode="zeros")
    with pytest.raises(ValueError):
        Fault(kind="corrupt_frame", fraction=0.0)
    with pytest.raises(ValueError):
        Fault(kind="hang_completion", delay_s=-1.0)
    with pytest.raises(ValueError):
        Fault(kind="corrupt_frame", times=0)
    with pytest.raises(TypeError):
        FaultPlan(faults=("corrupt_frame",))
    Fault(kind="drop_message", message="submit")  # transport kinds validate


def test_carry_faults_and_plan_hook():
    packer = MultiStreamPacker(CFG, device="cpu")
    packer.open("w", alpha=0.6)
    packer.open("c", alpha=0.0)
    frames = _frames(2)
    packer.pack({"w": frames[0], "c": frames[0]})
    assert packer.sessions["w"].carry is not None

    inj = FaultInjector(FaultPlan(faults=(Fault(kind="corrupt_carry", stream_id="w", mode="inf"),)))
    assert inj.apply_carry_faults(packer.sessions) == ["w"]
    assert torch.isinf(packer.sessions["w"].carry).all()
    assert packer.sessions["c"].carry is None
    assert packer.quarantine("w") is True
    assert packer.sessions["w"].carry is None
    assert packer.quarantine("w") is False
    assert packer.quarantine("nonexistent") is False
    assert packer.carry_resets == 1

    inj2 = FaultInjector(FaultPlan(faults=(Fault(kind="raise_dispatch", dispatch=0),)))
    plan = BGPlan(cfg=CFG, backend="reference", device="cpu")
    with inj2.plan_hook():
        with pytest.raises(InjectedFault):
            plan(np.stack([frames[0]]))
        plan(np.stack([frames[0]]))  # dispatch 1 serves
    assert set_dispatch_hook(None) is None  # restored after the block


# ----------------------------------------------------------------- admission
def test_admission_validation():
    frame = _frames(1)[0]
    assert validate_frame(frame).shape == frame.shape
    for bad in (
        np.full((8, 8), np.nan, np.float32),
        np.full((8, 8), np.inf, np.float32),
        np.zeros((8,), np.float32),
        np.zeros((2, 2, 2), np.float32),
        np.zeros((0, 8), np.float32),
        np.zeros((8, 8), np.complex64),
        np.array([["a", "b"], ["c", "d"]]),
    ):
        with pytest.raises(AdmissionError):
            validate_frame(bad)
    with pytest.raises(ValueError):
        validate_frame(np.full((4, 4), np.nan, np.float32), stream_id="s")


def test_engine_rejects_bad_frames_at_submit():
    with _engine(max_batch=4, batch_window_ms=5.0) as eng:
        with pytest.raises(AdmissionError):
            eng.submit(np.full((32, 48), np.nan, np.float32))
        st = eng.stats()
        assert st.submitted == 0 and st.failed == 0
        assert eng.flush(timeout=10.0)
        assert _finite(eng.submit(_frames(1)[0]).result(timeout=60.0))


# ------------------------------------------------------------ retry/fallback
def test_fallback_ladder_derivation():
    streamed = plan_for(CFG, 32, 48, backend="fused_streamed", sharded=False, device="cpu")
    ladder = streamed.fallback_ladder()
    assert [p.backend for p in ladder] == ["fused_streamed", "fused", "reference"]
    fused = plan_for(CFG, 32, 48, n_frames=4, temporal=True, sharded=False, device="cpu")
    assert [p.backend for p in fused.fallback_ladder()] == ["fused", "reference"]
    assert all(p.temporal for p in fused.fallback_ladder())
    ref = BGPlan(cfg=CFG, backend="reference", device="cpu")
    assert ref.fallback_ladder() == (ref,)
    assert ladder[-1].batch_tile is None and all(p.device == CPU for p in ladder)


def test_retry_recovers_transient_failure():
    calls, retries = [], []

    def flaky(plan):
        calls.append(plan)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "served"

    gd = GuardedDispatch(["primary", "fallback"], RetryPolicy(max_attempts=3, backoff_s=0.0),
                         on_retry=lambda: retries.append(1), sleep=lambda s: None)
    assert gd.call(flaky) == ("served", 0)
    assert calls == ["primary"] * 3 and len(retries) == 2


def test_breaker_opens_and_ladder_falls_back():
    clock = {"t": 0.0}
    attempts, fallbacks = [], []

    def broken_primary(plan):
        attempts.append(plan)
        if plan == "primary":
            raise RuntimeError("kernel backend down")
        return f"served by {plan}"

    gd = GuardedDispatch(
        ["primary", "fallback"],
        RetryPolicy(max_attempts=2, backoff_s=0.0, breaker_threshold=2, breaker_cooldown_s=100.0),
        on_fallback=lambda: fallbacks.append(1), sleep=lambda s: None, clock=lambda: clock["t"],
    )
    for _ in range(2):
        assert gd.call(broken_primary) == ("served by fallback", 1)
    assert gd.breakers[0].open
    n_before = len(attempts)
    result, rung = gd.call(broken_primary)
    assert rung == 1 and attempts[n_before:] == ["fallback"]
    assert len(fallbacks) == 3
    clock["t"] = 101.0
    gd.call(broken_primary)
    assert "primary" in attempts[n_before + 1:]


def test_last_rung_serves_even_when_open():
    gd = GuardedDispatch(
        ["only"],
        RetryPolicy(max_attempts=1, backoff_s=0.0, breaker_threshold=1, breaker_cooldown_s=1000.0),
        sleep=lambda s: None,
    )
    with pytest.raises(AllBackendsFailed):
        gd.call(lambda p: (_ for _ in ()).throw(RuntimeError("down")))
    assert gd.breakers[0].open
    assert gd.call(lambda p: "recovered") == ("recovered", 0)


def test_client_errors_fail_fast():
    attempts = []

    def buggy(plan):
        attempts.append(plan)
        raise KeyError("stream never opened")

    gd = GuardedDispatch(["a", "b"], RetryPolicy(backoff_s=0.0))
    with pytest.raises(KeyError):
        gd.call(buggy)
    assert attempts == ["a"]


def test_all_backends_failed_carries_cause():
    gd = GuardedDispatch(["a", "b"], RetryPolicy(max_attempts=2, backoff_s=0.0), sleep=lambda s: None)
    boom = RuntimeError("persistent")
    with pytest.raises(AllBackendsFailed) as exc:
        gd.call(lambda p: (_ for _ in ()).throw(boom))
    assert exc.value.attempts == 4 and exc.value.rungs == 2
    assert exc.value.__cause__ is boom


def test_breaker_state_machine():
    clock = {"t": 0.0}
    br = CircuitBreaker(threshold=2, cooldown_s=10.0, clock=lambda: clock["t"])
    assert br.allow() and not br.open
    br.record_failure()
    assert br.allow()
    br.record_failure()
    assert br.open and not br.allow()
    clock["t"] = 10.0
    assert br.allow()  # half-open probe
    br.record_failure()
    assert br.open
    clock["t"] = 20.0
    assert br.allow()
    br.record_success()
    assert not br.open and br.allow()


@pytest.mark.parametrize("error", [KernelBuildError, KernelLaunchError])
def test_kernel_errors_are_never_retried_or_laddered(error):
    """The port's one divergence from the JAX package: a kernel that does
    not build or launch raises through the ladder at once (no retry, no
    lower rung), and through the engine to the request's future."""
    attempts, retries, fallbacks = [], [], []

    def broken(plan):
        attempts.append(plan)
        raise error("csrc/bg_fused.cu: CUDA error 98 (invalid device function)")

    gd = GuardedDispatch(["fused_streamed", "fused", "reference"], RetryPolicy(backoff_s=0.0),
                         on_retry=lambda: retries.append(1), on_fallback=lambda: fallbacks.append(1))
    with pytest.raises(error):
        gd.call(broken)
    assert attempts == ["fused_streamed"] and not retries and not fallbacks
    assert issubclass(error, RuntimeError)  # pytest.raises(RuntimeError) still holds

    def hook(plan):
        if plan.backend != "reference":
            raise error(f"{plan.backend}: launch failed")

    prev = set_dispatch_hook(hook)
    try:
        with _engine(max_batch=2, batch_window_ms=5.0) as eng:
            fut = eng.submit(_frames(1)[0])
            with pytest.raises(error):
                fut.result(timeout=60.0)
            st = eng.stats()
    finally:
        set_dispatch_hook(prev)
    assert st.failed == 1 and st.retries == 0 and st.fallbacks == 0 and st.completed == 0


def test_build_and_launch_raise_their_own_classes(monkeypatch, tmp_path):
    """``kernels/_build.py`` raises ``KernelBuildError`` when nvcc is missing
    and ``KernelLaunchError`` for a CUDA error a launch returns."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        _build._nvcc()

    class FakeLib:
        @staticmethod
        def fake_error_string(err):
            return b"invalid argument"

    monkeypatch.setitem(_build._libs, "fake", FakeLib())
    _build.check("fake", 0)
    with pytest.raises(KernelLaunchError, match="CUDA error 1 .invalid argument."):
        _build.check("fake", 1)


def test_load_raises_build_error_for_a_bad_library(monkeypatch, tmp_path):
    """A library that does not load, or lacks an entry point, is a
    ``KernelBuildError`` (never retried, never laddered), not ctypes'
    ``OSError`` or ``AttributeError``."""
    import pathlib

    import _ctypes

    from repro_torch.kernels import _build

    bad = tmp_path / "broken.so"
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all", lambda names: {n: bad for n in names})
    with pytest.raises(KernelBuildError, match="cannot load broken.so"):
        _build.load("broken")
    # a library that loads but exports none of the kernel's symbols
    real = pathlib.Path(_ctypes.__file__)
    monkeypatch.setattr(_build, "build_all", lambda names: {n: real for n in names})
    with pytest.raises(KernelBuildError, match="no entry point stub_error_string"):
        _build.load("stub", {"stub_launch": ([], None)})
    assert not _build._libs


@pytest.mark.parametrize("module, query", [("bg_fused", "_device_limits"), ("bg_create", "_device_limits"),
                                           ("bg_blur", "_device_limits"), ("bg_slice", "_smem_limit")])
def test_device_query_failure_is_a_launch_error(module, query, monkeypatch):
    """A wrapper that cannot read the card's shared-memory limit raises
    ``KernelLaunchError``, so the guarded dispatch does not answer for it
    from a lower rung."""
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{module}")

    class FakeLib:
        def __getattr__(self, name):
            return lambda index: 0  # what the *_smem_optin entry points return on a CUDA error

    monkeypatch.setattr(mod, "_lib", lambda: FakeLib())
    with pytest.raises(KernelLaunchError, match="cannot query shared memory of cuda:0"):
        getattr(mod, query).__wrapped__(0)


@pytest.mark.parametrize("watchdog_ms", [None, 60_000.0])
def test_completion_cuda_error_is_not_redispatched(watchdog_ms, monkeypatch):
    """A CUDA error the wait on a batch's completion reports is a
    ``KernelLaunchError``: the batch fails as it is, with no redispatch,
    retry or lower rung (a hung completion, by contrast, is redispatched)."""
    launched = []

    class BrokenEvent:
        def synchronize(self):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with _engine(max_batch=2, batch_window_ms=5.0, watchdog_ms=watchdog_ms) as eng:
        real = eng._launch_with

        def launch(plan, batch, staging, x):
            launched.append(plan.backend)
            item = real(plan, batch, staging, x)
            item.event = BrokenEvent()
            return item

        monkeypatch.setattr(eng, "_launch_with", launch)
        fut = eng.submit(_frames(1)[0])
        with pytest.raises(KernelLaunchError, match="illegal memory access"):
            fut.result(timeout=60.0)
        st = eng.stats()
    assert launched == ["fused"]
    assert st.failed == 1 and st.completed == 0 and st.retries == 0 and st.fallbacks == 0
    assert st.watchdog_trips == 0


# ------------------------------------------- carry poisoning and quarantine
def test_nan_frame_poisons_carry_without_guards():
    frames = _frames(6, seed=5)
    packer = MultiStreamPacker(CFG, device="cpu")
    packer.open("s", alpha=0.7)
    assert _finite(packer.pack({"s": frames[0]})["s"])
    nan_frame = frames[1].copy()
    nan_frame[3, 4] = np.nan
    assert not _finite(packer.pack({"s": nan_frame})["s"])
    assert not _finite(packer.sessions["s"].carry)
    for t in (2, 3):  # clean frames, still poisoned through the carry
        assert not _finite(packer.pack({"s": frames[t]})["s"])
    assert packer.quarantine("s") is True
    for t in (4, 5):
        assert _finite(packer.pack({"s": frames[t]})["s"])


def test_pack_guarded_flags():
    _check_pack_guarded_flags("cpu")


@pytest.mark.gpu
def test_pack_guarded_flags_on_card(cuda):
    """On the card B2 quantizes in its store: a NaN that reaches the output
    stays NaN there (no clamp to 255), so the poisoned row is still
    flagged."""
    from repro_torch.kernels import bg_fused

    quantized = bg_fused.quantized_launches
    _check_pack_guarded_flags(cuda)
    assert bg_fused.quantized_launches > quantized


def _check_pack_guarded_flags(device):
    frames = _frames(1)
    nan_frame = frames[0].copy()
    nan_frame[0, 0] = np.nan
    packer = MultiStreamPacker(CFG, device=device)
    packer.open("bad", alpha=0.6)
    packer.open("good", alpha=0.6)
    packer.open("cold", alpha=0.0)
    _, guard = packer.pack_guarded({"bad": nan_frame, "good": frames[0], "cold": frames[0]})
    order = list(guard.order)
    assert sorted(order) == order
    out_ok = guard.out_ok.cpu().numpy()
    assert not out_ok[order.index("bad")]
    assert out_ok[order.index("good")] and out_ok[order.index("cold")]
    assert set(guard.carry_sids) == {"bad", "good"}
    flags = dict(zip(guard.carry_sids, guard.carry_ok.cpu().numpy()))
    assert not flags["bad"] and flags["good"]
    results, guard = packer.pack_guarded({})
    assert results == {} and guard.out_ok is None and guard.carry_sids == ()


def default_fault_plan(n_streams, *, hang_delay_s, seed=0):
    """benchmarks/bench_bg_chaos.py's acceptance schedule: NaN frames on 2
    streams, one dispatch exception (dispatch 0, retried as dispatch 1), one
    completion hang on dispatch 4 (round 3 when driven round by round)."""
    return FaultPlan(
        faults=(Fault(kind="corrupt_frame", stream_id=0, frame_index=1, mode="nan"),
                Fault(kind="corrupt_frame", stream_id=min(1, n_streams - 1), frame_index=2, mode="nan"),
                Fault(kind="raise_dispatch", dispatch=0),
                Fault(kind="hang_completion", dispatch=4, delay_s=hang_delay_s)),
        seed=seed,
    )


def test_engine_quarantines_exactly_the_poisoned_streams():
    n_streams, rounds = 8, 5
    relax = _relax()
    per_stream = {s: _frames(rounds, seed=100 + s) for s in range(n_streams)}
    packer = MultiStreamPacker(plan=plan_for(CFG, 32, 48, n_frames=n_streams, temporal=True, device="cpu"))
    for s in range(n_streams):
        packer.open(s, alpha=0.6)
    reset_sids = []
    orig = packer.quarantine
    packer.quarantine = lambda sid: (reset_sids.append(sid), orig(sid))[1]

    inj = FaultInjector(default_fault_plan(n_streams, hang_delay_s=1.5 * relax))
    with AsyncFrameEngine(packer=packer, max_batch=n_streams, batch_window_ms=50.0,
                          watchdog_ms=400.0 * relax) as eng:
        eng.fault_injector = inj
        outcomes = {}
        for t in range(rounds):
            futs = {s: eng.submit(per_stream[s][t], stream_id=s) for s in range(n_streams)}
            for s, f in futs.items():
                try:
                    assert _finite(f.result(timeout=120.0)), f"non-finite frame served ({s}, {t})"
                    outcomes[(s, t)] = "ok"
                except (NonFiniteOutput, EngineTimeout) as exc:
                    outcomes[(s, t)] = type(exc).__name__
        st = eng.stats()
        assert _finite(eng.submit(per_stream[0][0], stream_id=0).result(timeout=120.0))

    assert len(outcomes) == n_streams * rounds
    assert outcomes[(0, 1)] == "NonFiniteOutput"
    assert outcomes[(1, 2)] == "NonFiniteOutput"
    hung = [k for k, v in outcomes.items() if v == "EngineTimeout"]
    assert len(hung) in (0, n_streams)
    bad = {k for k, v in outcomes.items() if v == "NonFiniteOutput"} - {(0, 1), (1, 2)}
    assert not bad, bad
    assert sorted(reset_sids) == [0, 1]
    assert packer.carry_resets == 2
    for s in (0, 1):
        later = [outcomes[(s, t)] for t in range(3, rounds)]
        assert all(v in ("ok", "EngineTimeout") for v in later)
        assert any(v == "ok" for v in later)
    assert st.retries >= 1
    assert st.watchdog_trips == 1
    assert st.carry_resets == 2
    assert st.failed == len([v for v in outcomes.values() if v != "ok"])
    assert inj.fired == [1, 1, 1, 1]


def test_engine_fallback_serves_when_kernel_backend_dies():
    frames = _frames(2)
    inj = FaultInjector(FaultPlan(faults=(Fault(kind="raise_dispatch", backend="fused", times=None),)))
    with _engine(max_batch=2, batch_window_ms=5.0,
                 retry_policy=RetryPolicy(max_attempts=2, backoff_s=0.0)) as eng:
        eng.fault_injector = inj
        outs = [eng.submit(f).result(timeout=120.0) for f in frames]
        st = eng.stats()
    assert all(_finite(o) for o in outs)
    assert st.fallbacks == 2 and st.completed == 2 and st.failed == 0
    assert st.retries >= 2
    # the reference rung's frames are the fused route's, quantized
    want = BGPlan(CFG, device="cpu")(np.stack(frames))
    got = torch.stack(outs)
    assert float((got == want).float().mean()) >= 0.995 and float((got - want).abs().max()) <= 1.0


def test_engine_fallback_disabled_fails_requests():
    inj = FaultInjector(FaultPlan(faults=(Fault(kind="raise_dispatch", times=None),)))
    with _engine(max_batch=1, batch_window_ms=2.0, fallback=False,
                 retry_policy=RetryPolicy(max_attempts=2, backoff_s=0.0)) as eng:
        eng.fault_injector = inj
        fut = eng.submit(_frames(1)[0])
        with pytest.raises(AllBackendsFailed) as exc:
            fut.result(timeout=120.0)
        assert isinstance(exc.value.__cause__, InjectedFault)
        st = eng.stats()
    assert st.failed == 1 and st.completed == 0


# ------------------------------------------------- watchdog, shed, shutdown
def test_watchdog_transient_hang_recovers_via_redispatch():
    relax = _relax()
    frames = _frames(2)
    inj = FaultInjector(FaultPlan(faults=(Fault(kind="hang_completion", dispatch=1, delay_s=2.0 * relax),)))
    with _engine(max_batch=1, batch_window_ms=2.0, watchdog_ms=400.0 * relax) as eng:
        eng.fault_injector = inj
        assert _finite(eng.submit(frames[0]).result(timeout=120.0))  # dispatch 0
        assert _finite(eng.submit(frames[1]).result(timeout=120.0))  # dispatch 1 hangs
        st = eng.stats()
    assert st.watchdog_trips == 1
    assert st.failed == 0 and st.completed == 2


def test_watchdog_persistent_hang_fails_structurally():
    relax = _relax()
    frames = _frames(2)
    inj = FaultInjector(FaultPlan(faults=(Fault(kind="hang_completion", delay_s=1.5 * relax, times=None),)))
    with _engine(max_batch=1, batch_window_ms=2.0, watchdog_ms=300.0 * relax, fallback=False,
                 retry_policy=RetryPolicy(max_attempts=1, backoff_s=0.0)) as eng:
        eng.fault_injector = inj
        fut = eng.submit(frames[0])
        with pytest.raises(AllBackendsFailed) as exc:
            fut.result(timeout=120.0)
        cause = exc.value.__cause__
        assert isinstance(cause, EngineTimeout)
        assert cause.timeout_s == pytest.approx(0.3 * relax)
        assert len(cause.uids) == 1
        eng.fault_injector = None  # the hang clears: the engine outlives it
        assert _finite(eng.submit(frames[1]).result(timeout=120.0))
        st = eng.stats()
    assert st.watchdog_trips == 2  # the first wait and the redispatch's
    assert st.failed == 1 and st.completed == 1


def test_expired_deadline_is_shed():
    frames = _frames(2)
    with _engine(max_batch=4, batch_window_ms=2.0) as eng:
        fut = eng.submit(frames[0], deadline_ms=-1000.0)
        with pytest.raises(DeadlineExceeded) as exc:
            fut.result(timeout=60.0)
        assert exc.value.late_s >= 1.0
        assert _finite(eng.submit(frames[1]).result(timeout=60.0))
        st = eng.stats()
    assert st.shed == 1 and st.deadline_misses >= 1
    assert st.completed == 1 and st.dispatches == 1


def test_close_joins_threads_even_with_full_queue():
    relax = _relax()
    frames = _frames(1)
    inj = FaultInjector(FaultPlan(faults=(Fault(kind="hang_completion", delay_s=0.3 * relax, times=None),)))
    eng = _engine(max_batch=1, max_queue=1, max_inflight=1, batch_window_ms=0.0)
    eng.fault_injector = inj
    futs = [eng.submit(frames[0], block=True, timeout=30.0) for _ in range(4)]
    t0 = time.monotonic()
    eng.close(timeout=0.2 * relax)  # shorter than the drain: flush times out
    assert time.monotonic() - t0 < 15.0 * relax
    for t in (eng._dispatcher, eng._completer):
        t.join(timeout=30.0 * relax)
        assert not t.is_alive(), f"{t.name} leaked past close()"
    for f in futs:
        assert f.done()
        exc = f.exception(timeout=10.0)
        assert exc is None or isinstance(exc, EngineClosed)
    assert any(isinstance(f.exception(), EngineClosed) for f in futs)


def test_submit_after_close_raises_engine_closed():
    eng = _engine(max_batch=1)
    eng.close()
    with pytest.raises(EngineClosed):
        eng.submit(_frames(1)[0])
    with pytest.raises(RuntimeError):
        eng.submit(_frames(1)[0])


# ------------------------------------------------------------ the chaos soak
def _traffic(n_streams, rounds, h, w, phase_seed):
    vids = [synthetic_video_np(s, rounds, h, w, motion=1.5) for s in range(n_streams)]
    rng = np.random.default_rng(phase_seed)
    return [(s, np.clip(np.floor(vids[s][t] + rng.normal(0.0, 30.0, (h, w)) + 0.5), 0.0, 255.0)
             .astype(np.float32)) for t in range(rounds) for s in range(n_streams)]


def _drive(eng, arrivals):
    """Submit every arrival, realize every future: (seconds, ok, errors,
    corrupt_served)."""
    t0 = time.perf_counter()
    futs = [eng.submit(frame, stream_id=sid) for sid, frame in arrivals]
    ok, errors, corrupt = 0, {}, 0
    for f in futs:
        try:
            out = f.result(timeout=120.0)
        except Exception as exc:  # structured failure: counted
            errors[type(exc).__name__] = errors.get(type(exc).__name__, 0) + 1
            continue
        ok += 1
        corrupt += not _finite(out)
    if futs and futs[-1].done():
        out = futs[-1].result() if futs[-1].exception() is None else None
        if out is not None and out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    return time.perf_counter() - t0, ok, errors, corrupt


def chaos_soak(device, *, n_streams=8, rounds=4, h=32, w=48, watchdog_ms=600.0, hang_delay_s=2.0, reps=2):
    """benchmarks/bench_bg_chaos.py's soak on the port: a clean phase
    (best of ``reps``), the acceptance fault schedule, an untimed settle
    pass, and a recovery phase (best of ``reps``) on one warm video
    engine."""
    plan = plan_for(CFG, h, w, n_frames=n_streams, temporal=True, device=device, cache=False)
    packer = MultiStreamPacker(plan=plan)
    for s in range(n_streams):
        packer.open(s, alpha=0.6)
    eng = AsyncFrameEngine(packer=packer, max_batch=n_streams, batch_window_ms=50.0, watchdog_ms=watchdog_ms)
    res = {}
    try:
        _drive(eng, _traffic(n_streams, 2, h, w, 9_000_000))  # warm-up

        def timed(seed):
            runs = [_drive(eng, _traffic(n_streams, rounds, h, w, seed + 10_000 * k)) for k in range(reps)]
            return min(r[0] for r in runs), sum(r[3] for r in runs), all(not r[2] for r in runs)

        res["clean_s"], corrupt, res["clean_all_ok"] = timed(0)
        injector = FaultInjector(default_fault_plan(n_streams, hang_delay_s=hang_delay_s))
        eng.fault_injector = injector
        resets0 = packer.carry_resets
        _, _, res["faulted_errors"], c = _drive(eng, _traffic(n_streams, rounds, h, w, 1_000_000))
        eng.flush()
        eng.fault_injector = None
        corrupt += c
        res["faulted_carry_resets"] = packer.carry_resets - resets0
        _, _, _, c = _drive(eng, _traffic(n_streams, rounds, h, w, 1_500_000))  # settle
        corrupt += c
        res["recovery_s"], c, res["recovery_all_ok"] = timed(2_000_000)
        res["corrupt_served"] = corrupt + c
        res["stats"] = eng.stats()
        res["fired"] = list(injector.fired)
        res["all_resolved"] = eng.flush(timeout=60.0)
    finally:
        eng.close()
    frames = n_streams * rounds
    res["fps_clean"], res["fps_recovery"] = frames / res["clean_s"], frames / res["recovery_s"]
    return res


def _check_soak_structure(res):
    assert res["all_resolved"], res
    assert res["corrupt_served"] == 0
    assert res["faulted_carry_resets"] >= 2  # both poisoned streams reset
    assert res["stats"].watchdog_trips == 1 and res["stats"].retries >= 1
    assert res["fired"] == [1, 1, 1, 1]
    assert res["clean_all_ok"] and res["recovery_all_ok"]
    assert set(res["faulted_errors"]) <= {"NonFiniteOutput", "EngineTimeout"}


def test_chaos_soak_recovers_structurally():
    """The soak's structural half, on the CPU: every future resolves, no
    corrupted frame is served as a success, the poisoned streams reset,
    the schedule shows as one watchdog trip and a retry, and the clean and
    recovery phases fail nothing. No wall-clock ratio is asserted here."""
    relax = _relax()
    _check_soak_structure(chaos_soak(CPU, watchdog_ms=600.0 * relax, hang_delay_s=2.0 * relax))


@pytest.mark.gpu
def test_chaos_soak_recovers_throughput_on_card(cuda):
    """The soak on the card: its structural half, and recovery at >= 0.8x
    the clean phase's throughput (best ratio of two soaks, as the JAX
    package's test takes)."""
    best = 0.0
    for _ in range(2):
        res = chaos_soak(cuda)
        _check_soak_structure(res)
        best = max(best, res["fps_recovery"] / res["fps_clean"])
        if best >= 0.8:
            break
    assert best >= 0.8, res
