"""The port's plan, data pipeline, frame engine and launcher against the JAX
package's, on the same numpy frames (CPU; the fused backend runs its plain
version there). Quantized outputs must agree on >= 99.5 % of pixels with at
most 1 LSB apart (tests/test_kernels.py)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import BGConfig as JBGConfig
from repro.plan import BGPlan as JBGPlan
from repro.plan import plan_for as jplan_for
from repro.serving import FrameDenoiseEngine as JEngine
from repro.serving import FrameRequest as JRequest
from repro_torch.core import BGConfig, synthetic_image, synthetic_image_np
from repro_torch.data.pipeline import denoise_batch
from repro_torch.kernels import bilateral_grid_filter_pallas
from repro_torch.plan import BGPlan, plan_for
from repro_torch.serving import AsyncFrameEngine, FrameDenoiseEngine, FrameRequest
from repro_torch.sharding import BatchMesh
from repro_torch.video import MultiStreamPacker, carry_shape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = (6, 4.0, 60.0)
CFG, JCFG = BGConfig(*ARGS), JBGConfig(*ARGS)


def frames_np(b, h=45, w=64, seed=0):
    clean = np.stack([synthetic_image_np(h, w, seed=seed + i) for i in range(b)])
    noise = np.random.default_rng(seed + 50).normal(0.0, 30.0, clean.shape)
    return np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32)


def quantized_contract(a, b):
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.mean(diff == 0.0) >= 0.995, np.mean(diff == 0.0)
    assert diff.max() <= 1.0


# ---------------------------------------------------------------- BGPlan
REJECTED = [
    (dict(backend="warp_drive"), "backend"),
    (dict(precision="fp8"), "precision"),
    (dict(backend="streaming", precision="bf16"), "bf16"),
    (dict(batch_tile=0), "batch_tile"),
    (dict(batch_tile=-2), "batch_tile"),
    (dict(batch_tile=1.5), "batch_tile"),
    (dict(batch_tile=2.0), "batch_tile"),
    (dict(batch_tile=True), "batch_tile"),
    (dict(backend="fused_streamed", temporal=True), "stream_input"),
    (dict(backend="streaming", temporal=True), "temporal"),
]
# valid JAX plans the port did not run before mesh sharding was ported:
# mesh plans (on a one-device host the JAX plan_for degrades sharded=True to
# a plain plan, and so does the port's on the CPU)
NOT_PORTED = [
    dict(backend="streaming", sharded=True),
    dict(backend="fused", sharded=True, quantize_output=False),
]
# valid JAX plans that were not ported before the bf16 storage form was
BF16_PLANS = [
    dict(backend="fused_streamed", precision="bf16"),
    dict(temporal=True, precision="bf16"),
    dict(backend="reference", temporal=True, precision="bf16"),
    dict(precision="bf16"),
]


@pytest.mark.parametrize("kwargs,match", REJECTED)
def test_plan_rejects_what_the_jax_plan_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        JBGPlan(cfg=JCFG, **kwargs)
    with pytest.raises(ValueError, match=match):
        BGPlan(cfg=CFG, device="cpu", **kwargs)


def test_plan_rejects_non_paper_kernel_backend():
    classic = (4, 3.0, 50.0)
    with pytest.raises(ValueError, match="paper"):
        JBGPlan(cfg=JBGConfig(*classic, normalize_mode="classic"), backend="fused")
    with pytest.raises(ValueError, match="paper"):
        BGPlan(cfg=BGConfig(*classic, normalize_mode="classic"), backend="fused", device="cpu")
    # the reference backend takes either normalization in both packages
    BGPlan(cfg=BGConfig(*classic, normalize_mode="classic"), backend="reference", device="cpu")


@pytest.mark.parametrize("kwargs", NOT_PORTED)
def test_valid_jax_plans_not_yet_ported_raise(kwargs):
    """These mesh plans are ported now (the name is from before they were).
    With one device (JAX's host here, the port's CPU) ``sharded=True`` is
    the plain plan in both packages, and the outputs agree (the quantized
    contract, or atol 5e-3 unquantized, tests/test_kernels.py); over an
    explicit 2-handle mesh the port's output is its plain plan's bit for
    bit."""
    jplan = jplan_for(JCFG, 45, 64, **kwargs)  # valid there
    plan = plan_for(CFG, 45, 64, device="cpu", **kwargs)
    assert (plan.mesh, jplan.mesh) == (None, None)
    assert (plan.backend, plan.quantize_output) == (jplan.backend, jplan.quantize_output)
    x = frames_np(3)
    mine, theirs = plan(x), np.asarray(jplan(x))
    if plan.quantize_output:
        quantized_contract(mine.numpy(), theirs)
    else:
        np.testing.assert_allclose(mine.numpy(), theirs, atol=5e-3)
    meshed = plan_for(CFG, 45, 64, device="cpu", mesh=BatchMesh(("cpu",) * 2), **kwargs)
    assert meshed.mesh_size == 2 and torch.equal(meshed(x), mine)


@pytest.mark.parametrize("kwargs", BF16_PLANS)
def test_bf16_jax_plans_are_ported(kwargs):
    """Each bf16 plan the JAX package takes builds on the CPU with bf16
    storage and runs one small pack (a temporal plan a cold one, then a warm
    one on the bf16 carry it returned)."""
    jplan = JBGPlan(cfg=JCFG, **kwargs)
    plan = BGPlan(cfg=CFG, device="cpu", **kwargs)
    assert plan.storage_dtype == torch.bfloat16 and jplan.precision == plan.precision == "bf16"
    assert plan.np_storage_dtype == np.float32  # the snapshot side: numpy has no bfloat16
    frames = frames_np(2)
    if plan.temporal:
        carry = torch.zeros((2,) + carry_shape(45, 64, CFG), dtype=torch.bfloat16)
        out, carry = plan(frames, carry=carry, alpha=0.0)
        out, carry = plan(frames, carry=carry, alpha=[0.0, 0.6])
        assert carry.dtype == torch.bfloat16 and carry.shape == (2,) + carry_shape(45, 64, CFG)
    else:
        out = plan(frames)
    assert out.dtype == torch.float32 and out.shape == frames.shape
    assert bool(torch.isfinite(out).all())


def test_plan_normalizes_like_jax():
    assert BGPlan(CFG, backend="reference", batch_tile=4, device="cpu").batch_tile is None
    assert JBGPlan(JCFG, backend="reference", batch_tile=4).batch_tile is None
    a = BGPlan(CFG, batch_tile=2, device="cpu")
    b = BGPlan(CFG, batch_tile=2, device=torch.device("cpu"))
    assert a == b and hash(a) == hash(b)
    assert a.executable() is b.executable()  # one executable per equal plan
    assert a.executable() is not BGPlan(CFG, batch_tile=3, device="cpu").executable()


def test_plan_without_device_needs_a_card():
    if torch.cuda.is_available():
        assert BGPlan(CFG).device.type == "cuda"
        return
    for make in (
        lambda: BGPlan(CFG),
        lambda: BGPlan(CFG, device="cuda"),
        lambda: BGPlan.from_json(BGPlan(CFG, device="cpu").to_json()),
        lambda: FrameDenoiseEngine(CFG),
        lambda: synthetic_image(8, 8),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_from_json_of_a_jax_payload_gives_the_same_output():
    jplan = JBGPlan(cfg=JCFG, backend="fused", batch_tile=2, interpret=True)
    payload = json.loads(json.dumps(jplan.to_json()))
    plan = BGPlan.from_json(payload, device="cpu")
    assert (plan.cfg, plan.backend, plan.batch_tile, plan.device.type) == (CFG, "fused", 2, "cpu")
    frames = frames_np(3)
    out = plan(frames)
    assert out.shape == frames.shape and out.dtype == torch.float32
    quantized_contract(out.numpy(), np.asarray(jplan(frames)))
    # and back: the JAX package reads the port's payload as the same recipe
    back = JBGPlan.from_json(json.loads(json.dumps(plan.to_json())))
    assert back == JBGPlan(cfg=JCFG, backend="fused", batch_tile=2)


def test_from_json_rejects_what_is_not_ported():
    payload = JBGPlan(cfg=JCFG, backend="fused").to_json()
    # a mesh payload is ported now: "auto" wants that many cards (none on
    # the CPU), an explicit mesh rebinds it as the same recipe, mesh=None to
    # one device
    with pytest.raises(ValueError, match="2-device mesh"):
        BGPlan.from_json(dict(payload, mesh_size=2), device="cpu")
    meshed = BGPlan.from_json(dict(payload, mesh_size=2), mesh=BatchMesh(("cpu",) * 2))
    assert meshed.to_json() == dict(payload, mesh_size=2) and meshed.device.type == "cpu"
    assert BGPlan.from_json(dict(payload, mesh_size=2), mesh=None, device="cpu").mesh_size == 1
    # a streaming payload is ported now: it loads as the same recipe
    streaming = BGPlan.from_json(dict(payload, backend="streaming"), device="cpu")
    assert streaming.plan_hash() == JBGPlan.from_json(dict(payload, backend="streaming")).plan_hash()
    # a bf16 payload is ported now: it loads, and goes back as the JAX recipe
    jbf16 = JBGPlan(cfg=JCFG, backend="fused_streamed", batch_tile=2, precision="bf16")
    plan = BGPlan.from_json(json.loads(json.dumps(jbf16.to_json())), device="cpu")
    assert (plan.precision, plan.backend, plan.batch_tile) == ("bf16", "fused_streamed", 2)
    assert plan.storage_dtype == torch.bfloat16 and "prec=bf16" in plan.describe()
    assert JBGPlan.from_json(json.loads(json.dumps(plan.to_json()))) == jbf16
    no_field = {k: v for k, v in payload.items() if k != "precision"}
    assert BGPlan.from_json(no_field, device="cpu").precision == "fp32"
    with pytest.raises(ValueError, match="version"):
        BGPlan.from_json(dict(payload, version=2), device="cpu")


@pytest.mark.parametrize("backend", ["fused_streamed", "staged"])
def test_streamed_and_staged_plans_are_accepted(backend):
    plan = BGPlan(CFG, backend=backend, batch_tile=2, device="cpu")
    jplan = JBGPlan(cfg=JCFG, backend=backend, batch_tile=2)
    # batch_tile is a fused-family field in both packages
    assert plan.batch_tile == jplan.batch_tile == (2 if backend == "fused_streamed" else None)
    assert plan.executable() is BGPlan(CFG, backend=backend, batch_tile=2, device="cpu").executable()
    with pytest.raises(ValueError, match="temporal"):
        BGPlan(CFG, backend=backend, temporal=True, device="cpu")
    assert BGPlan.from_json(json.loads(json.dumps(plan.to_json())), device="cpu") == plan


@pytest.mark.parametrize("backend", ["fused_streamed", "staged"])
def test_from_json_of_a_jax_streamed_or_staged_payload(backend):
    jplan = JBGPlan(cfg=JCFG, backend=backend, batch_tile=3, interpret=True)
    plan = BGPlan.from_json(json.loads(json.dumps(jplan.to_json())), device="cpu")
    assert (plan.cfg, plan.backend, plan.device.type) == (CFG, backend, "cpu")
    assert plan.batch_tile == jplan.batch_tile
    frames = frames_np(3, 40, 55, seed=6)
    quantized_contract(plan(frames).numpy(), np.asarray(jplan(frames)))
    back = JBGPlan.from_json(json.loads(json.dumps(plan.to_json())))
    assert back == JBGPlan(cfg=JCFG, backend=backend, batch_tile=3)


@pytest.mark.parametrize("backend", ["reference", "fused", "fused_streamed", "staged"])
def test_backends_match_jax(backend):
    frames = frames_np(2, 40, 55, seed=4)
    out = BGPlan(CFG, backend=backend, device="cpu")(frames)
    ref = JBGPlan(JCFG, backend=backend, interpret=True)(frames)
    quantized_contract(out.numpy(), np.asarray(ref))
    raw = BGPlan(CFG, backend=backend, quantize_output=False, device="cpu")(frames[0])
    assert raw.shape == frames[0].shape and not torch.equal(raw, torch.floor(raw))


@pytest.mark.parametrize("backend", ["reference", "fused", "staged"])
def test_color_frames_fold_channels_into_batch(backend):
    base = frames_np(3, 40, 55)
    color = np.stack([base, base[:, ::-1], base[:, :, ::-1]], axis=-1)
    plan = BGPlan(CFG, backend=backend, device="cpu")
    out = denoise_batch(color, plan=plan)
    assert out.shape == color.shape
    per_channel = torch.stack([denoise_batch(color[..., c].copy(), plan=plan) for c in range(3)], -1)
    assert torch.equal(out, per_channel)
    assert torch.equal(bilateral_grid_filter_pallas(color, plan=plan), out)
    jout = JBGPlan(JCFG, backend=backend, interpret=True)(color)
    quantized_contract(out.numpy(), np.asarray(jout))


# ---------------------------------------------------------------- engine
def test_frame_engine_matches_jax_engine_with_ragged_flush():
    frames = frames_np(7, 40, 55, seed=9)
    eng = FrameDenoiseEngine(CFG, max_batch=3, device="cpu")
    jeng = JEngine(JCFG, max_batch=3)
    for i in range(7):
        eng.submit(FrameRequest(uid=i, frame=frames[i]))
        jeng.submit(JRequest(uid=i, frame=frames[i]))
    sizes = []
    done = []
    while eng.pending():
        batch = eng.step()
        sizes.append(len(batch))
        done.extend(batch)
    assert sizes == [3, 3, 1] and eng.step() == []
    jdone = jeng.flush()
    assert [r.uid for r in done] == [r.uid for r in jdone] == list(range(7))
    for r, jr in zip(done, jdone):
        assert r.result.device.type == "cpu" and r.result.shape == (40, 55)
        quantized_contract(r.result.numpy(), np.asarray(jr.result))


def test_frame_engine_stream_input_builds_the_streamed_plan():
    frames = frames_np(5, 40, 55, seed=3)
    eng = FrameDenoiseEngine(CFG, max_batch=2, stream_input=True, device="cpu")
    jeng = JEngine(JCFG, max_batch=2, stream_input=True)
    assert eng.plan.backend == jeng.plan.backend == "fused_streamed"
    for i in range(5):
        eng.submit(FrameRequest(uid=i, frame=frames[i]))
        jeng.submit(JRequest(uid=i, frame=frames[i]))
    done, jdone = eng.flush(), jeng.flush()
    assert [r.uid for r in done] == [r.uid for r in jdone] == list(range(5))
    for r, jr in zip(done, jdone):
        quantized_contract(r.result.numpy(), np.asarray(jr.result))
    with pytest.raises(ValueError, match="stream_input"):
        FrameDenoiseEngine(plan=BGPlan(CFG, device="cpu"), stream_input=True)


def test_async_engine_stream_input_builds_the_streamed_plan():
    from repro.serving import AsyncFrameEngine as JAsyncEngine

    frames = frames_np(3, 40, 55, seed=5)
    with AsyncFrameEngine(CFG, max_batch=3, stream_input=True, device="cpu") as eng:
        assert eng.plan.backend == "fused_streamed"
        outs = [f.result() for f in [eng.submit(f) for f in frames]]
    with JAsyncEngine(JCFG, max_batch=3, stream_input=True) as jeng:
        assert jeng.plan.backend == "fused_streamed"
        jouts = [f.result() for f in [jeng.submit(f) for f in frames]]
    for o, jo in zip(outs, jouts):
        quantized_contract(o.numpy(), np.asarray(jo))
    with pytest.raises(ValueError, match="stream_input"):
        AsyncFrameEngine(plan=BGPlan(CFG, device="cpu"), stream_input=True)
    with pytest.raises(ValueError, match="stream_input"):
        AsyncFrameEngine(packer=MultiStreamPacker(CFG, device="cpu"), stream_input=True)


def test_packer_rejects_input_streamed_plan():
    """The JAX package's tests/test_plan.py test of the same name."""
    from repro.video import MultiStreamPacker as JPacker

    with pytest.raises(ValueError, match="fused_streamed"):
        JPacker(plan=JBGPlan(cfg=JCFG, backend="fused_streamed"))
    with pytest.raises(ValueError, match="fused_streamed"):
        MultiStreamPacker(plan=BGPlan(CFG, backend="fused_streamed", device="cpu"))


def test_frame_engine_rejections_match_jax():
    for bad in (0, -1):
        with pytest.raises(ValueError, match="max_batch"):
            JEngine(JCFG, max_batch=bad)
        with pytest.raises(ValueError, match="max_batch"):
            FrameDenoiseEngine(CFG, max_batch=bad, device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        FrameDenoiseEngine(plan=BGPlan(CFG, quantize_output=False, device="cpu"))
    with pytest.raises(TypeError):
        FrameDenoiseEngine()
    with pytest.raises(ValueError, match="device"):
        FrameDenoiseEngine(plan=BGPlan(CFG, device="cpu"), device="cpu")
    eng = FrameDenoiseEngine(plan=BGPlan(CFG, device="cpu"), max_batch=2)
    assert eng.flush() == [] and eng.device.type == "cpu" and eng.cfg == CFG


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--frames", "4",
         "--frame-hw", "48x64", "--device", "cpu", "--micro-batch", "3"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] 4 frames 48x64 on cpu" in proc.stdout
    assert "2 dispatches" in proc.stdout


def test_serve_launcher_stream_input_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--frames", "2",
         "--frame-hw", "40x55", "--stream-input", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] 2 frames 40x55 on cpu" in proc.stdout
    assert "backend=fused_streamed" in proc.stdout
    # on the CPU the plain version serves: no kernel launch is counted
    assert "launches b1=0 b3=0" in proc.stdout


def test_serve_frames_reports_backend_and_launches():
    from repro_torch.launch.serve import serve_frames

    st = serve_frames(3, 24, 30, micro_batch=2, device="cpu", stream_input=True)
    assert st["backend"] == "fused_streamed" and st["dispatches"] == 2
    assert st["bg_fused_launches"] == st["bg_fused_streamed_launches"] == 0
    assert serve_frames(2, 24, 30, micro_batch=2, device="cpu")["backend"] == "fused"
