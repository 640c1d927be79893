"""The port's temporal video path against the JAX package's, on the same
numpy inputs (CPU; the fused backend runs its plain version there).

Tolerances are the JAX package's own: temporal image atol 5e-3 and carry
atol 2e-2 / rtol 1e-3 against the staged oracle
(tests/test_temporal_fused.py), alpha-0 new carries atol 2e-2 / rtol 1e-4
against the frame's own blurred grid, and quantized frames equal on
>= 99.5 % of pixels, at most 1 LSB apart (tests/test_kernels.py). The
bitwise contracts (alpha-0 rows, no cross-stream leak) are held within the
port. Bitwise pack composition is not compared with the reference: the
reference itself does not hold it (ROADMAP queue C).
"""
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import BGConfig, psnr
from repro_torch.core.bilateral_grid import grid_blur, grid_create, quantize_intensity
from repro_torch.data import synthetic_video, synthetic_video_np
from repro_torch.kernels import bg_fused, bg_fused_plain
from repro_torch.plan import BGPlan
from repro_torch.video import MultiStreamPacker, blurred_grid_batch, carry_shape, temporal_denoise

ARGS = (6, 4.0, 60.0)
CFG = BGConfig(*ARGS)
# ragged (h % r != 0) and stripe-aligned (h % r == 0, the drain plane) packs
PACK_SHAPES = [((45, 55), 3), ((33, 47), 5), ((36, 48), 4)]
IMG_ATOL = 5e-3
CARRY_TOL = dict(atol=2e-2, rtol=1e-3)


@pytest.fixture
def jx():
    """The JAX package's video path (imported here, not at module level, so
    the card's host, which has no JAX, can collect this file)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import BGConfig as JBGConfig
    from repro.data import synthetic_video as j_synthetic_video
    from repro.kernels import bg_fused as j_bg_fused
    from repro.plan import BGPlan as JBGPlan
    from repro.video import MultiStreamPacker as JPacker
    from repro.video import blurred_grid_batch as j_blurred_grid_batch
    from repro.video import temporal_denoise as j_temporal_denoise

    return SimpleNamespace(
        np=jnp.asarray, cfg=JBGConfig(*ARGS), bg_fused=j_bg_fused, plan=JBGPlan,
        packer=JPacker, blurred=j_blurred_grid_batch, temporal=j_temporal_denoise,
        video=j_synthetic_video,
    )


def noisy_stack(n, h, w, seed=0):
    """n frames of a panning synthetic video plus numpy noise, 8-bit."""
    vid = synthetic_video_np(seed, n, h, w, motion=1.5)
    noise = np.random.default_rng(seed + 100).normal(0.0, 30.0, vid.shape)
    return np.clip(np.floor(vid + noise + 0.5), 0.0, 255.0).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def quantized_contract(a, b):
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.mean(diff == 0.0) >= 0.995, np.mean(diff == 0.0)
    assert diff.max() <= 1.0


def zero_carry(n, h, w):
    return torch.zeros((n,) + carry_shape(h, w, CFG))


# ------------------------------------------------------------- fixtures
def test_synthetic_video_matches_jax_bit_for_bit(jx):
    for args in ((5, 4, 40, 60, 2.0), (1, 3, 48, 64, 0.0), (7, 5, 33, 47, 1.5)):
        port = synthetic_video_np(*args)
        assert port.dtype == np.float32 and port.shape == args[1:2] + args[2:4]
        np.testing.assert_array_equal(port, np.asarray(jx.video(*args)))
        assert torch.equal(synthetic_video(*args, device="cpu"), t(port))
    static = synthetic_video_np(5, 3, 40, 60, motion=0.0)
    np.testing.assert_array_equal(static[0], static[2])
    with pytest.raises(ValueError):
        synthetic_video_np(0, 0, 40, 60)


# ------------------------------------------------- the temporal kernel
@pytest.mark.parametrize("shape,n", PACK_SHAPES)
def test_plain_temporal_matches_jax_kernel_chained(jx, shape, n):
    """Three chained steps, each package on its own carry: the port's plain
    temporal version against the JAX fused kernel (interpret mode)."""
    h, w = shape
    alpha = np.asarray([0.0, 0.4, 0.8, 0.6, 0.3][:n], np.float32)
    carry, jcarry = zero_carry(n, h, w), jx.np(zero_carry(n, h, w).numpy())
    for step in range(3):
        frames = noisy_stack(n, h, w, seed=31 * step)
        out, carry = bg_fused(t(frames), CFG, carry=carry, alpha=t(alpha))
        jout, jcarry = jx.bg_fused(
            jx.np(frames), jx.cfg, interpret=True, carry=jcarry, alpha=jx.np(alpha)
        )
        assert carry.shape == (n,) + carry_shape(h, w, CFG)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry), **CARRY_TOL)


@pytest.mark.parametrize("shape,n", PACK_SHAPES)
def test_alpha0_rows_bitwise_per_frame(shape, n):
    h, w = shape
    frames = t(noisy_stack(n, h, w))
    rng = np.random.default_rng(1)
    carry = t(rng.uniform(0.0, 4.0, (n,) + carry_shape(h, w, CFG)).astype(np.float32))
    alpha = t(np.asarray([0.0 if i % 2 == 0 else 0.6 for i in range(n)], np.float32))
    ref = bg_fused(frames, CFG)
    out, new_carry = bg_fused(frames, CFG, carry=carry, alpha=alpha)
    for i in range(0, n, 2):
        assert torch.equal(out[i], ref[i])
    out0, _ = bg_fused(frames, CFG, carry=carry, alpha=torch.zeros(n))
    assert torch.equal(out0, ref)
    # b == 1 equals its row of the batch, image and carry; a squeezed frame
    # takes a (gx, gy, gz, 2) carry and one alpha
    o1, c1 = bg_fused(frames[1:2], CFG, carry=carry[1:2], alpha=alpha[1:2])
    assert torch.equal(o1[0], out[1]) and torch.equal(c1[0], new_carry[1])
    o, c = bg_fused(frames[1], CFG, carry=carry[1], alpha=alpha[1:2])
    assert torch.equal(o, out[1]) and torch.equal(c, new_carry[1])


def test_alpha0_new_carry_is_own_blurred_grid(jx):
    frames = noisy_stack(3, 45, 55)
    _, new_carry = bg_fused(t(frames), CFG, carry=zero_carry(3, 45, 55), alpha=torch.zeros(3))
    ref = blurred_grid_batch(t(frames), CFG)
    np.testing.assert_allclose(new_carry.numpy(), ref.numpy(), atol=2e-2, rtol=1e-4)
    jref = np.asarray(jx.blurred(jx.np(frames), jx.cfg))
    np.testing.assert_allclose(new_carry.numpy(), jref, atol=2e-2, rtol=1e-4)


def test_h_divisible_emits_the_drain_plane(jx):
    """h % r == 0: carry plane gx-1 is one TI never reads; it must still be
    the frame's blurred plane, and the image equals the per-frame path."""
    h, w = 36, 48
    assert h % CFG.r == 0
    frames = noisy_stack(2, h, w)
    gx = carry_shape(h, w, CFG)[0]
    out, new_carry = bg_fused(t(frames), CFG, carry=zero_carry(2, h, w), alpha=torch.zeros(2))
    jref = np.asarray(jx.blurred(jx.np(frames), jx.cfg))
    assert float(np.abs(jref[:, gx - 1]).max()) > 0.0
    np.testing.assert_allclose(new_carry[:, gx - 1].numpy(), jref[:, gx - 1], atol=2e-2, rtol=1e-4)
    assert torch.equal(out, bg_fused(t(frames), CFG))


def test_temporal_operand_checks_match_jax(jx):
    frames = t(noisy_stack(2, 33, 47))
    good = zero_carry(2, 33, 47)
    with pytest.raises(ValueError, match="both carry= and alpha="):
        bg_fused(frames, CFG, carry=good)
    with pytest.raises(ValueError, match="both carry= and alpha="):
        jx.bg_fused(jx.np(frames.numpy()), jx.cfg, interpret=True, carry=jx.np(good.numpy()))
    with pytest.raises(ValueError, match="carry shape"):
        bg_fused(frames, CFG, carry=good[:, :-1].contiguous(), alpha=torch.zeros(2))
    with pytest.raises(ValueError, match="alpha shape"):
        bg_fused(frames, CFG, carry=good, alpha=torch.zeros(3))
    with pytest.raises(TypeError, match="float32"):
        bg_fused(frames, CFG, carry=good.double(), alpha=torch.zeros(2))


# ----------------------------------------------------------- video layer
def test_blurred_grid_batch_matches_jax_and_per_frame(jx):
    frames = noisy_stack(4, 33, 47)
    port = blurred_grid_batch(t(frames), CFG)
    per_frame = torch.stack([grid_blur(grid_create(f, CFG), CFG) for f in t(frames)])
    assert torch.equal(port, per_frame)
    np.testing.assert_allclose(
        port.numpy(), np.asarray(jx.blurred(jx.np(frames), jx.cfg)), atol=1e-3, rtol=1e-5
    )


def test_temporal_denoise_reference_matches_jax_staged(jx):
    """The port's staged oracle (reference plan) against the JAX package's
    ``temporal_denoise(staged=True)``, chained, unquantized and quantized;
    and the port's fused route against its own oracle."""
    n, h, w = 3, 33, 47
    alpha = np.asarray([0.0, 0.5, 0.8], np.float32)
    ref_plan = BGPlan(CFG, backend="reference", quantize_output=False, device="cpu")
    fused_plan = BGPlan(CFG, backend="fused", quantize_output=False, device="cpu")
    c_ref = c_fused = jc = None
    for step in range(3):
        frames = noisy_stack(n, h, w, seed=7 * step)
        o_ref, c_ref = temporal_denoise(frames, carry=c_ref, alpha=alpha, plan=ref_plan)
        o_fused, c_fused = temporal_denoise(frames, carry=c_fused, alpha=alpha, plan=fused_plan)
        jo, jc = jx.temporal(
            jx.np(frames), jx.cfg, carry=jc, alpha=alpha, staged=True, quantize_output=False
        )
        np.testing.assert_allclose(o_ref.numpy(), np.asarray(jo), atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(c_ref.numpy(), np.asarray(jc), **CARRY_TOL)
        np.testing.assert_allclose(o_fused.numpy(), o_ref.numpy(), atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(c_fused.numpy(), c_ref.numpy(), **CARRY_TOL)
        quantized_contract(quantize_intensity(o_fused, CFG), quantize_intensity(t(np.asarray(jo)), CFG))


@pytest.mark.parametrize("lo,hi", [(-60.0, 0.0), (-60.0, -50.0), (255.0, 330.0)])
@pytest.mark.parametrize("args", [(4, 2.0, 30.0), (12, 8.0, 70.0)])
def test_temporal_reference_matches_jax_out_of_range(jx, args, lo, hi):
    """Frames outside [0, 255] (the validity guard admits any finite frame)
    through the port's staged oracle and the JAX package's, chained at
    alpha 0.5: jnp turns a negative grid index into index + size before its
    scatter drops, or its gather clamps, what is still out of range."""
    from repro.core import BGConfig as JBGConfig

    cfg, jcfg = BGConfig(*args), JBGConfig(*args)
    alpha = np.full(2, 0.5, np.float32)
    plan = BGPlan(cfg, backend="reference", quantize_output=False, device="cpu")
    rng = np.random.default_rng(5)
    carry = jc = None
    for _ in range(2):
        frames = rng.uniform(lo, hi, (2, 37, 53)).astype(np.float32)
        out, carry = temporal_denoise(frames, carry=carry, alpha=alpha, plan=plan)
        jo, jc = jx.temporal(
            jx.np(frames), jcfg, carry=jc, alpha=alpha, staged=True, quantize_output=False
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(carry.numpy(), np.asarray(jc), **CARRY_TOL)


def test_temporal_denoise_cold_and_warm_up_packs():
    frames = noisy_stack(3, 45, 55)
    per_frame = BGPlan(CFG, device="cpu")(frames)
    out, carry = temporal_denoise(frames, CFG, alpha=0.0, device="cpu")
    assert carry is None and torch.equal(out, per_frame)  # nothing temporal
    out1, carry1 = temporal_denoise(frames[0], CFG, alpha=0.0, device="cpu")
    assert carry1 is None and torch.equal(out1, per_frame[0])
    # alpha > 0 with no history: effective alpha 0, and a carry comes out
    out, carry = temporal_denoise(frames, CFG, alpha=0.5, device="cpu")
    assert torch.equal(out, per_frame) and carry.shape == (3,) + carry_shape(45, 55, CFG)
    for bad in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError, match="alpha"):
            temporal_denoise(frames, CFG, alpha=bad, device="cpu")
    with pytest.raises(ValueError, match="leading axis"):
        temporal_denoise(frames, CFG, carry=zero_carry(2, 45, 55), alpha=0.5, device="cpu")
    with pytest.raises(TypeError):
        temporal_denoise(frames)


# ---------------------------------------------------------------- plans
def test_temporal_plan_json_round_trips_with_jax(jx):
    jplan = jx.plan(cfg=jx.cfg, backend="fused", temporal=True, batch_tile=2, interpret=True)
    plan = BGPlan.from_json(json.loads(json.dumps(jplan.to_json())), device="cpu")
    assert (plan.temporal, plan.backend, plan.batch_tile) == (True, "fused", 2)
    back = jx.plan.from_json(json.loads(json.dumps(plan.to_json())))
    assert back == jx.plan(cfg=jx.cfg, backend="fused", temporal=True, batch_tile=2)
    frames = noisy_stack(3, 33, 47)
    carry = np.random.default_rng(2).uniform(0, 4, (3,) + carry_shape(33, 47, CFG)).astype(np.float32)
    alpha = [0.2, 0.0, 0.7]
    out, new_carry = plan(frames, carry=carry, alpha=alpha)
    jout, jcarry = jplan(jx.np(frames), carry=jx.np(carry), alpha=alpha)
    quantized_contract(out.numpy(), np.asarray(jout))
    np.testing.assert_allclose(new_carry.numpy(), np.asarray(jcarry), **CARRY_TOL)


def test_temporal_plan_call_checks():
    plan = BGPlan(CFG, temporal=True, device="cpu")
    frames = noisy_stack(2, 33, 47)
    carry = zero_carry(2, 33, 47)
    with pytest.raises(ValueError, match="carry= and alpha="):
        plan(frames, carry=carry)
    with pytest.raises(ValueError, match="alpha"):
        plan(frames, carry=carry, alpha=[0.5, 1.0])
    with pytest.raises(ValueError, match="temporal plan"):
        BGPlan(CFG, device="cpu")(frames, carry=carry, alpha=0.5)
    out, c = plan(frames[0], carry=carry[0], alpha=0.3)  # squeezed, scalar alpha
    assert out.shape == (33, 47) and c.shape == carry_shape(33, 47, CFG)
    # a tensor alpha is trusted (no host check); a 0-d one is broadcast
    out2, c2 = plan(frames, carry=carry, alpha=torch.tensor(0.3))
    assert torch.equal(out2[0], out) and torch.equal(c2[0], c)
    assert plan.tile_for(5) == 5 and BGPlan(CFG, batch_tile=2, device="cpu").tile_for(5) == 2
    assert plan.as_temporal(True) is plan and plan.as_temporal(False) is plan.as_temporal(False)
    assert plan.as_temporal(False).as_temporal(True) == plan
    assert plan.with_tile(3) is plan.with_tile(3) and plan.with_tile(None) is plan
    assert plan.with_options(batch_tile=4).batch_tile == 4
    assert plan.storage_dtype == torch.float32 and plan.np_storage_dtype == np.float32


# --------------------------------------------------------------- packer
def test_mixed_pack_is_single_dispatch(monkeypatch):
    session_mod = importlib.import_module("repro_torch.video.session")
    calls = []
    real = session_mod.temporal_denoise

    def counting(*args, **kwargs):
        calls.append(kwargs.get("alpha"))
        return real(*args, **kwargs)

    monkeypatch.setattr(session_mod, "temporal_denoise", counting)
    packer = MultiStreamPacker(CFG, device="cpu")
    packer.open("cold", alpha=0.0)
    packer.open("warm", alpha=0.6)
    packer.open("fresh", alpha=0.4)
    frames = noisy_stack(3, 33, 47)
    packer.pack({"cold": frames[0], "warm": frames[1], "fresh": frames[2]})
    assert len(calls) == 1
    packer.pack({"cold": frames[2], "warm": frames[0], "fresh": frames[1]})
    assert len(calls) == 2
    assert packer.sessions["cold"].carry is None
    assert packer.sessions["warm"].carry is not None and packer.sessions["fresh"].carry is not None


def test_packer_no_cross_stream_leak():
    cfg = BGConfig(4, 4.0, 60.0)
    nA, nB = noisy_stack(5, 40, 56, seed=3), noisy_stack(5, 40, 56, seed=7)
    solo = MultiStreamPacker(cfg, device="cpu")
    solo.open("A", alpha=0.5)
    solo_out = [solo.pack({"A": nA[i]})["A"] for i in range(5)]
    duo = MultiStreamPacker(cfg, device="cpu")
    duo.open("A", alpha=0.5)
    duo.open("B", alpha=0.7)
    for i in range(5):
        assert torch.equal(solo_out[i], duo.pack({"A": nA[i], "B": nB[i]})["A"])
    assert duo.sessions["A"].frames_seen == duo.sessions["B"].frames_seen == 5


def test_static_scene_psnr_rises_with_alpha():
    cfg = BGConfig(4, 4.0, 60.0)
    clean = synthetic_video_np(1, 1, 48, 64, motion=0.0)[0]
    rng = np.random.default_rng(100)
    noisy = [np.clip(np.floor(clean + rng.normal(0, 30, clean.shape) + 0.5), 0, 255).astype(np.float32)
             for _ in range(12)]
    vals = []
    for alpha in (0.0, 0.3, 0.6, 0.8):
        packer = MultiStreamPacker(cfg, device="cpu")
        packer.open(0, alpha=alpha)
        for f in noisy:
            out = packer.pack({0: f})[0]
        vals.append(float(psnr(t(clean), out)))
    assert all(b > a for a, b in zip(vals, vals[1:])), vals


def test_cold_streams_never_carry_and_stay_per_frame():
    packer = MultiStreamPacker(CFG, device="cpu")
    packer.open("warm", alpha=0.6)
    packer.open("cold", alpha=0.0)
    frames = noisy_stack(2, 33, 47)
    per_frame = BGPlan(CFG, device="cpu")(frames)
    for i in range(2):
        outs = packer.pack({"warm": frames[i], "cold": frames[i]})
        assert torch.equal(outs["cold"], per_frame[i])
    assert packer.sessions["warm"].carry is not None and packer.sessions["cold"].carry is None
    allzero = MultiStreamPacker(CFG, device="cpu")
    allzero.open(0)
    allzero.open(1)
    out = allzero.pack({0: frames[0], 1: frames[1]})
    assert torch.equal(out[0], per_frame[0]) and torch.equal(out[1], per_frame[1])
    assert allzero.sessions[0].carry is None


def test_packer_errors():
    packer = MultiStreamPacker(CFG, device="cpu")
    packer.open("a", alpha=0.2)
    with pytest.raises(ValueError):
        packer.open("a")
    with pytest.raises(ValueError):
        packer.open("bad", alpha=1.0)
    with pytest.raises(KeyError):
        packer.pack({"ghost": np.zeros((24, 24), np.float32)})
    packer.open("b", alpha=0.2)
    with pytest.raises(ValueError, match="equal"):
        packer.pack({"a": np.zeros((24, 24), np.float32), "b": np.zeros((30, 24), np.float32)})
    assert packer.pack({}) == {}
    packer.close("b")
    assert packer.live() == 1
    with pytest.raises(TypeError):
        MultiStreamPacker()
    with pytest.raises(ValueError, match="device"):
        MultiStreamPacker(plan=BGPlan(CFG, device="cpu"), device="cpu")


def test_quarantine_resets_to_cold_and_rewarms():
    packer = MultiStreamPacker(CFG, device="cpu")
    packer.open("s", alpha=0.6)
    frames = noisy_stack(3, 33, 47)
    packer.pack({"s": frames[0]})
    assert packer.quarantine("s") and packer.carry_resets == 1
    assert not packer.quarantine("s") and not packer.quarantine("ghost")
    # the next pack is a first frame again: the per-frame output
    out = packer.pack({"s": frames[1]})["s"]
    assert torch.equal(out, BGPlan(CFG, device="cpu")(frames[1]))
    assert packer.sessions["s"].carry is not None and packer.sessions["s"].frames_seen == 2


def test_pack_guarded_flags():
    packer = MultiStreamPacker(CFG, device="cpu")
    packer.open("w", alpha=0.5)
    packer.open("c", alpha=0.0)
    frames = noisy_stack(2, 33, 47)
    _, guard = packer.pack_guarded({"w": frames[0], "c": frames[1]})
    assert guard.order == ("c", "w")  # sorted by repr
    assert guard.out_ok.tolist() == [True, True] and guard.carry_sids == ("w",)
    assert guard.carry_ok.tolist() == [True]
    _, guard = packer.pack_guarded({"w": frames[1]}, carry_limit=1e-3)
    assert guard.carry_ok.tolist() == [False]  # out of range: quarantine it


def test_carries_restored_from_the_jax_packer(jx):
    """Three packs through the JAX packer; its numpy snapshot restored into
    the port's packer; the fourth pack agrees."""
    sids, alphas = ("a", "b", "c"), {"a": 0.4, "b": 0.0, "c": 0.8}
    h, w = 36, 48
    jpacker = jx.packer(jx.cfg)
    port = MultiStreamPacker(CFG, device="cpu")
    for s in sids:
        jpacker.open(s, alpha=alphas[s])
        port.open(s, alpha=alphas[s])
    streams = {s: noisy_stack(4, h, w, seed=11 * i) for i, s in enumerate(sids)}
    for step in range(3):
        jpacker.pack({s: jx.np(streams[s][step]) for s in sids})
    snap = jpacker.export_carries()
    assert sorted(snap) == ["a", "c"]  # cold streams carry nothing
    for s, (carry, alpha, seen) in snap.items():
        assert isinstance(carry, np.ndarray)
        port.restore_carry(s, carry, alpha=alpha, frames_seen=seen)
    port.sessions["b"].frames_seen = 3
    assert port.carry_restores == 2
    jout = jpacker.pack({s: jx.np(streams[s][3]) for s in sids})
    out = port.pack({s: streams[s][3] for s in sids})
    for s in sids:
        quantized_contract(out[s].numpy(), np.asarray(jout[s]))
    for s in ("a", "c"):
        np.testing.assert_allclose(
            port.sessions[s].carry.numpy(), np.asarray(jpacker.sessions[s].carry), **CARRY_TOL
        )
        assert port.sessions[s].frames_seen == jpacker.sessions[s].frames_seen == 4
    # and back: the port's snapshot is the JAX layout
    back = port.export_carries()
    assert back["a"][0].shape == carry_shape(h, w, CFG) and back["a"][0].dtype == np.float32


def test_restore_carry_is_all_or_nothing():
    packer = MultiStreamPacker(CFG, device="cpu")
    packer.open("s", alpha=0.3)
    good = np.ones(carry_shape(33, 47, CFG), np.float32)
    nan = good.copy()
    nan[1, 2, 0, 1] = np.nan
    for bad, kw, err in (
        (good[..., :1], {}, ValueError),
        (good[0], {}, ValueError),
        (nan, {}, ValueError),
        (good, {"alpha": 1.0}, ValueError),
    ):
        with pytest.raises(err):
            packer.restore_carry("s", bad, frames_seen=9, **kw)
        sess = packer.sessions["s"]
        assert sess.carry is None and sess.alpha == 0.3 and sess.frames_seen == 0
    with pytest.raises(KeyError):
        packer.restore_carry("ghost", good)
    assert packer.carry_restores == 0
    packer.restore_carry("s", torch.from_numpy(good), alpha=0.5, frames_seen=2)
    sess = packer.sessions["s"]
    assert torch.equal(sess.carry, torch.from_numpy(good)) and sess.alpha == 0.5
    assert sess.frames_seen == 2 and packer.carry_restores == 1


# ---------------------------------------------------- bf16 on the card
@pytest.fixture
def cuda():
    """The CUDA device; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(36, 48), (33, 47)])
def test_bf16_packer_on_card(cuda, shape):
    """A bf16 packer on the card: three packs of three streams (alphas 0,
    0.4, 0.8) launch only the bf16 temporal entry point (the first on zero
    carries at alpha 0), keep bf16 carries on the card, give the plain version's frames on the
    card bit for bit, and round-trip a snapshot bit for bit."""
    plan = BGPlan(CFG, precision="bf16", device=cuda)
    packer = MultiStreamPacker(plan=plan)
    for s, a in (("a", 0.0), ("b", 0.4), ("c", 0.8)):
        packer.open(s, alpha=a)
    streams = {s: noisy_stack(4, *shape, seed=5 * i) for i, s in enumerate("abc")}
    names = ("launches", "temporal_launches", "bf16_launches", "bf16_temporal_launches")
    before = {c: getattr(bg_fused, c) for c in names}
    carry = None
    for step in range(3):
        frames = {s: streams[s][step] for s in "abc"}
        out = packer.pack(frames)
        x = torch.stack([t(frames[s]) for s in "abc"]).to(cuda).to(torch.bfloat16)
        alpha = torch.tensor([0.0, 0.4 if carry is not None else 0.0, 0.8 if carry is not None else 0.0],
                             device=cuda)
        if carry is None:
            carry = torch.zeros((3,) + carry_shape(*shape, CFG), device=cuda, dtype=torch.bfloat16)
        p_out, carry = bg_fused_plain(x, CFG, carry=carry, alpha=alpha, precision="bf16")
        for i, s in enumerate("abc"):
            assert out[s].device == cuda and out[s].dtype == torch.float32
            assert torch.equal(out[s], quantize_intensity(p_out[i].float(), CFG))
    torch.cuda.synchronize()
    after = {c: getattr(bg_fused, c) - v for c, v in before.items()}
    assert after == {"launches": 0, "temporal_launches": 0, "bf16_launches": 0, "bf16_temporal_launches": 3}
    for s, i in (("b", 1), ("c", 2)):
        assert packer.sessions[s].carry.dtype == torch.bfloat16 and packer.sessions[s].carry.is_cuda
        assert torch.equal(packer.sessions[s].carry, carry[i])
    snap = packer.export_carries()
    fresh = MultiStreamPacker(plan=plan)
    for s in "abc":
        fresh.open(s, alpha=packer.sessions[s].alpha)
    for s, (c, a, seen) in snap.items():
        fresh.restore_carry(s, c, alpha=a, frames_seen=seen)
        assert torch.equal(fresh.sessions[s].carry, packer.sessions[s].carry)
