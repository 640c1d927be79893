"""The port's async frame engine: the non-timing cases of the JAX package's
tests/test_async_engine.py, run on the CPU (the fused backend runs its plain
version there), plus the guards, telemetry and the video launcher.

Everything here is scheduling-order independent: futures resolve whenever
the background threads get there.
"""
import os
import queue
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import BGConfig
from repro_torch.data import synthetic_video_np
from repro_torch.launch.serve import serve_video
from repro_torch.plan import BGPlan
from repro_torch.reliability import AdmissionError, EngineClosed
from repro_torch.serving import AsyncFrameEngine, EngineStats, FrameDenoiseEngine, FrameRequest
from repro_torch.video import MultiStreamPacker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = BGConfig(4, 4.0, 60.0)


def frames_np(n, h=32, w=48, seed=0):
    vid = synthetic_video_np(seed, n, h, w, motion=1.0)
    noise = np.random.default_rng(seed).normal(0.0, 30.0, vid.shape)
    return list(np.clip(np.floor(vid + noise + 0.5), 0.0, 255.0).astype(np.float32))


def packer(**alphas):
    p = MultiStreamPacker(CFG, device="cpu")
    for s, a in alphas.items():
        p.open(s, alpha=a)
    return p


def test_results_match_sync_engine():
    frames = frames_np(11)
    sync = FrameDenoiseEngine(CFG, max_batch=4, device="cpu")
    for i, f in enumerate(frames):
        sync.submit(FrameRequest(uid=i, frame=f))
    ref = {r.uid: r.result for r in sync.flush()}
    with AsyncFrameEngine(CFG, max_batch=4, batch_window_ms=20.0, device="cpu") as eng:
        futs = [eng.submit(f) for f in frames]
        for i, fut in enumerate(futs):
            assert torch.equal(fut.result(timeout=60.0), ref[i])
        st = eng.stats()
    assert st["submitted"] == st["completed"] == 11
    assert st["dispatches"] >= 3  # max_batch 4 caps every micro-batch
    assert st["latency_ms_p99"] >= st["latency_ms_p50"] > 0.0
    assert st.failed == st.shed == 0


def test_video_mode_matches_solo_packer():
    n_frames, sids = 5, ("s0", "s1", "s2")
    per_stream = {s: frames_np(n_frames, seed=i * 11) for i, s in enumerate(sids)}
    alphas = {"s0": 0.5, "s1": 0.0, "s2": 0.7}
    with AsyncFrameEngine(max_batch=3, batch_window_ms=20.0, packer=packer(**alphas)) as eng:
        futs = [(s, i, eng.submit(per_stream[s][i], stream_id=s)) for i in range(n_frames) for s in sids]
        outs = {(s, i): f.result(timeout=60.0) for s, i, f in futs}
    for s in sids:
        solo = packer(**{s: alphas[s]})
        for i in range(n_frames):
            assert torch.equal(solo.pack({s: per_stream[s][i]})[s], outs[(s, i)])


def test_video_mode_defers_same_stream_frames():
    frames = frames_np(6, seed=3)
    p = packer(only=0.6)
    with AsyncFrameEngine(max_batch=8, batch_window_ms=5.0, packer=p) as eng:
        futs = [eng.submit(f, stream_id="only") for f in frames]
        [f.result(timeout=60.0) for f in futs]
        st = eng.stats()
    assert st["dispatches"] == 6 and st["mean_batch"] == 1.0
    assert p.sessions["only"].frames_seen == 6


def test_concurrent_clients_stress():
    """More client threads than cores, each its own stream, with a short
    switch interval: every future resolves, the counters add up, and each
    stream's frames come back in its order (equal to the stream alone)."""
    n_clients, n_frames = (os.cpu_count() or 4) + 4, 4
    per_stream = {s: frames_np(n_frames, 16, 24, seed=s) for s in range(n_clients)}
    p = packer(**{str(s): 0.5 for s in range(n_clients)})
    outs, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with AsyncFrameEngine(max_batch=8, batch_window_ms=1.0, max_queue=16, packer=p) as eng:
            def client(s):
                try:
                    futs = [eng.submit(f, stream_id=str(s)) for f in per_stream[s]]
                    outs[s] = [f.result(timeout=60.0) for f in futs]
                except Exception as exc:  # surfaced by the assert below
                    errors.append(exc)

            threads = [threading.Thread(target=client, args=(s,)) for s in range(n_clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120.0)
            assert not any(th.is_alive() for th in threads) and not errors, errors
            st = eng.stats()
    finally:
        sys.setswitchinterval(old)
    assert st.submitted == st.completed == n_clients * n_frames and st.failed == 0
    for s in range(n_clients):
        assert p.sessions[str(s)].frames_seen == n_frames
        solo = packer(**{str(s): 0.5})
        for i in range(n_frames):
            assert torch.equal(solo.pack({str(s): per_stream[s][i]})[str(s)], outs[s][i])


def test_deferred_frames_keep_stream_order():
    """A pack takes one frame per stream; the frames it defers go back ahead
    of the held frames behind them, so a stream's frames leave in order even
    when a pack fills before the held queue drains (the race behind rare
    failures of test_concurrent_clients_stress)."""
    from concurrent.futures import Future

    from repro_torch.serving.async_engine import AsyncFrameRequest

    eng = AsyncFrameEngine(max_batch=3, batch_window_ms=1.0, packer=packer(a=0.5, b=0.5, c=0.5))
    eng.close()  # no dispatch thread: collect packs by hand
    held = [("a", 1), ("a", 2), ("b", 1), ("c", 1), ("a", 3), ("b", 2)]
    eng._held.extend(AsyncFrameRequest(uid=i, frame=None, future=Future(), t_submit=0.0, stream_id=s)
                     for s, i in held)
    sent = {}
    while eng._held:
        pack = eng._collect_batch()
        assert len({r.stream_id for r in pack}) == len(pack)
        for r in pack:
            sent.setdefault(r.stream_id, []).append(r.uid)
    assert sent == {"a": [1, 2, 3], "b": [1, 2], "c": [1]}


def test_backpressure_and_flush():
    frame = frames_np(1)[0]
    with AsyncFrameEngine(CFG, max_batch=1, max_queue=2, batch_window_ms=0.0, device="cpu") as eng:
        rejected, futs = 0, []
        for _ in range(50):
            try:
                futs.append(eng.submit(frame, block=False))
            except queue.Full:
                rejected += 1
        assert rejected > 0  # the bounded queue sheds load
        assert eng.flush(timeout=60.0)
        assert all(f.done() for f in futs)
        st = eng.stats()
        assert st["submitted"] == st["completed"] == len(futs)


def test_dispatch_errors_fail_futures_not_engine():
    frames = frames_np(2)
    with AsyncFrameEngine(max_batch=2, batch_window_ms=5.0, packer=packer(ok=0.0)) as eng:
        bad = eng.submit(frames[0], stream_id="ghost")  # stream never opened
        with pytest.raises(KeyError):
            bad.result(timeout=60.0)
        good = eng.submit(frames[1], stream_id="ok")  # engine still serves
        assert good.result(timeout=60.0).shape == frames[1].shape
        assert eng.stats().failed == 1


def test_cancelled_future_does_not_kill_engine():
    frames = frames_np(2)
    with AsyncFrameEngine(CFG, max_batch=64, batch_window_ms=150.0, device="cpu") as eng:
        f1 = eng.submit(frames[0])
        f1.cancel()  # races the window; both outcomes must be survivable
        f2 = eng.submit(frames[1])
        assert f2.result(timeout=60.0).shape == frames[1].shape
        assert f1.cancelled() or f1.done()
        eng.submit(frames[0]).result(timeout=60.0)


def test_validation_and_lifecycle():
    for bad_kw in ({"max_batch": 0}, {"max_batch": -2}, {"max_queue": 0}, {"max_inflight": 0}):
        with pytest.raises(ValueError):
            AsyncFrameEngine(CFG, device="cpu", **bad_kw)
    with pytest.raises(TypeError):
        AsyncFrameEngine()
    with pytest.raises(ValueError, match="quantized"):
        AsyncFrameEngine(plan=BGPlan(CFG, quantize_output=False, device="cpu"))
    with pytest.raises(ValueError, match="plan"):
        AsyncFrameEngine(packer=packer(), plan=BGPlan(CFG, device="cpu"))
    with pytest.raises(ValueError, match="device"):
        AsyncFrameEngine(plan=BGPlan(CFG, device="cpu"), device="cpu")
    eng = AsyncFrameEngine(CFG, max_batch=2, packer=packer())
    with pytest.raises(ValueError):
        eng.submit(frames_np(1)[0])  # video mode requires a stream_id
    eng.close()
    eng.close()  # idempotent
    with pytest.raises(EngineClosed):
        eng.submit(frames_np(1)[0], stream_id="x")


def test_admission_rejects_bad_frames():
    with AsyncFrameEngine(CFG, device="cpu") as eng:
        nan = frames_np(1)[0]
        nan[3, 4] = np.nan
        for bad in (nan, np.zeros((2, 3, 4)), np.zeros((0, 5)), np.array([["a"]])):
            with pytest.raises(AdmissionError):
                eng.submit(bad)
        assert eng.stats().submitted == 0


def test_runaway_carry_is_quarantined():
    """A carry that passes restore (finite) but is out of range trips the
    carry guard at completion: the stream is reset to cold, and its next
    frame is served as a first frame."""
    frames = frames_np(3, seed=5)
    p = packer(s=0.5)
    huge = np.full((32 // 4 + 2, 48 // 4 + 2, CFG.gz, 2), 1e13, np.float32)
    p.restore_carry("s", huge)
    with AsyncFrameEngine(max_batch=1, packer=p) as eng:
        eng.submit(frames[0], stream_id="s").result(timeout=60.0)
        eng.flush(timeout=60.0)
        assert eng.stats().carry_resets == 1 and p.sessions["s"].carry is None
        out = eng.submit(frames[1], stream_id="s").result(timeout=60.0)
    assert torch.equal(out, BGPlan(CFG, device="cpu")(frames[1]))


def test_engine_stats_merge():
    a = EngineStats(4, 4, 2, 0, 0, 1, 2.0, 5.0, 9.0, failed=1, latency_samples=(1.0, 5.0, 9.0, 9.5))
    b = EngineStats(6, 5, 1, 1, 1, 0, 5.0, 3.0, 4.0, carry_resets=2, shed=1, latency_samples=(2.0, 3.0))
    m = EngineStats.merge([a, None, b])
    assert (m.submitted, m.completed, m.dispatches, m.failed, m.carry_resets, m.shed) == (10, 9, 3, 1, 2, 1)
    assert m.mean_batch == pytest.approx(3.0)  # dispatch-weighted
    assert m.latency_samples == (1.0, 2.0, 3.0, 5.0, 9.0, 9.5)
    assert (m.latency_ms_p50, m.latency_ms_p99) == (5.0, 9.5)
    assert "latency_samples" not in m.as_dict() and m["shed"] == 1
    with pytest.raises(KeyError):
        m["nope"]
    empty = EngineStats.merge([])
    assert empty.dispatches == 0 and empty.latency_ms_p99 == 0.0
    # without samples: a completed-weighted average of the percentiles
    c = EngineStats(1, 1, 1, 0, 0, 0, 1.0, 2.0, 4.0)
    d = EngineStats(3, 3, 1, 0, 0, 0, 1.0, 6.0, 8.0)
    assert EngineStats.merge([c, d]).latency_ms_p50 == pytest.approx(5.0)


def test_serve_video_on_cpu():
    st = serve_video(2, 3, 36, 48, alpha=0.6, device="cpu")
    assert st["frames"] == 6 and st["streams"] == 2 and st["device"] == "cpu"
    assert st["failed"] == st["shed"] == 0 and st["frames_per_s"] > 0
    assert 3 <= st["dispatches"] <= 6 and st["latency_ms_p99"] >= st["latency_ms_p50"] > 0
    # launches count only on the card
    assert st["bg_fused_launches"] == st["bg_fused_temporal_launches"] == 0


def test_serve_video_launcher_cli():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--video", "2", "--video-frames", "3",
         "--frame-hw", "36x48", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] video: 6 frames (2 streams) 36x48 on cpu" in proc.stdout
    assert "failed=0" in proc.stdout
