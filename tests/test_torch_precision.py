"""The bf16 storage form of the fused filter (``precision="bf16"``) in the
port against the JAX package's, on the same numpy inputs (CPU; the fused
backends run their plain versions there, the JAX fused calls run in
interpret mode, as the JAX package's own tests run them).

The port rounds where ``repro_torch/kernels/bg_fused.py``'s docstring says,
which differs from the TPU kernel in two places (a partial plane at a
stripe boundary, and the current raw plane in GF), so the two are held to
the JAX package's own bf16 tolerances (tests/test_plan.py:685-690):
unquantized atol 2.0 and quantized outputs at most 2 LSB apart; temporal
carries atol 2e-2 / rtol 1.6e-2 (two bf16 ulps; the JAX package's own
fused-vs-oracle gap is 0.0081 relative). Inside the port the bitwise
contracts hold (alpha-0 rows, the streamed form, snapshots), and every
fp32 plan gives the bytes it gave before bf16 was ported.
"""
import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import BGConfig, grid_shape, mssim, quantize_intensity, synthetic_image_np
from repro_torch.core.bilateral_grid import grid_normalize
from repro_torch.kernels import bg_fused, bg_fused_plain
from repro_torch.kernels.bg_blur import bg_blur_plain
from repro_torch.kernels.bg_create import bg_create_plain
from repro_torch.kernels.bg_slice import bg_slice_plain
from repro_torch.kernels.common import precision_bytes, round_storage, storage_dtype
from repro_torch.plan import BGPlan
from repro_torch.video import MultiStreamPacker, blurred_grid_batch

CASES = [((19, 26), (4, 3.0, 50.0)), ((60, 96), (12, 8.0, 70.0)), ((37, 53), (4, 3.0, 50.0))]
IDS = ["19x26-r4", "60x96-r12", "37x53-r4-odd-width"]
B = 3
IMG_ATOL = 2.0  # bf16 vs bf16 across the packages, tests/test_plan.py:688
LSB = 2.0  # quantized, bf16 vs bf16 across the packages
CARRY_TOL = dict(atol=2e-2, rtol=1.6e-2)
ALPHAS = np.asarray([0.0, 0.6, 0.8], np.float32)


@pytest.fixture
def jx():
    """The JAX package's fused kernel, plan and video path (imported here, so
    the card's host, which has no JAX, can collect this file)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import BGConfig as JBGConfig
    from repro.kernels import bg_fused as j_bg_fused
    from repro.plan import BGPlan as JBGPlan
    from repro.video import MultiStreamPacker as JPacker
    from repro.video import blurred_grid_batch as j_blurred_grid_batch

    return SimpleNamespace(
        np=jnp.asarray, cfg=JBGConfig, bg_fused=j_bg_fused, plan=JBGPlan, packer=JPacker,
        blurred=j_blurred_grid_batch,
    )


def noisy(b, h, w, seed=0):
    """b synthetic scenes plus numpy noise, 8-bit quantized."""
    clean = np.stack([synthetic_image_np(h, w, seed=seed + i) for i in range(b)])
    noise = np.random.default_rng(seed + 100).normal(0.0, 30.0, clean.shape)
    return np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32)


def f32(a) -> np.ndarray:
    """Any array of either package (ml_dtypes bf16 too) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def within_lsb(a, b, lsb=LSB) -> float:
    """Largest difference of two quantized outputs, asserted <= ``lsb``;
    returns the share of equal pixels."""
    diff = np.abs(f32(a).astype(np.float64) - f32(b))
    assert diff.max() <= lsb, diff.max()
    return float(np.mean(diff == 0.0))


# ------------------------------------------------------ storage helpers
def test_storage_helpers():
    assert storage_dtype("fp32") == torch.float32 and storage_dtype("bf16") == torch.bfloat16
    assert precision_bytes("fp32") == 4 and precision_bytes("bf16") == 2
    x = torch.tensor([1.0 + 2.0**-9, 1.0 + 3 * 2.0**-9, 255.0, 3.14159265])
    assert round_storage(x, "fp32") is x
    # round to nearest even: 1 + 2^-9 ties to 1, 1 + 3 * 2^-9 to 1 + 2^-7
    assert round_storage(x, "bf16").tolist() == [1.0, 1.0 + 2.0**-7, 255.0, 3.140625]
    for fn in (storage_dtype, precision_bytes):
        with pytest.raises(ValueError, match="precision"):
            fn("fp16")


# ------------------------------------------- the kernels' plain versions
@pytest.mark.parametrize("stream_input", [False, True], ids=["fused", "fused_streamed"])
@pytest.mark.parametrize("shape,args", CASES, ids=IDS)
def test_bf16_fused_matches_jax_bf16_fused(jx, shape, args, stream_input):
    """The port's bf16 plain fused filter against the JAX package's bf16
    fused kernel (default and streamed input): unquantized atol 2.0,
    quantized at most 2 LSB apart."""
    frames = noisy(B, *shape, seed=sum(shape))
    cfg, jcfg = BGConfig(*args), jx.cfg(*args)
    port = bg_fused(torch.from_numpy(frames).to(torch.bfloat16), cfg, precision="bf16",
                    stream_input=stream_input)
    assert port.dtype == torch.bfloat16 and port.shape == frames.shape
    ref = jx.bg_fused(jx.np(frames), jcfg, interpret=True, precision="bf16",
                      stream_input=stream_input)
    np.testing.assert_allclose(f32(port), f32(ref), atol=IMG_ATOL, rtol=0)
    within_lsb(quantize_intensity(port.float(), cfg), quantize_intensity(torch.from_numpy(f32(ref)), cfg))
    # inside the port the streamed form is the default one bit for bit
    assert torch.equal(port, bg_fused_plain(torch.from_numpy(frames).to(torch.bfloat16), cfg,
                                            precision="bf16"))


def _contract_bf16(x, cfg, raw=True, norm=True, zweight=True, carry=False):
    """The bf16 contract in the staged plain versions, with any of its
    rounding points (raw cell, normalized plane, z weights) left out: the
    controls a port that rounds elsewhere would be. ``carry`` returns the
    alpha-0 carry, the frame's blurred grid in bf16."""
    x = x.to(torch.float32)
    grid = bg_create_plain(x, cfg)
    if raw:
        grid = round_storage(grid, "bf16")
    blurred = bg_blur_plain(grid, cfg)
    if carry:
        return blurred.to(torch.bfloat16)
    planes = grid_normalize(blurred)
    if norm:
        planes = round_storage(planes, "bf16")
    zdt = torch.bfloat16 if zweight else torch.float32
    return bg_slice_plain(planes, x, cfg, zweight_dtype=zdt).to(torch.bfloat16)


@pytest.mark.parametrize("shape,args", CASES, ids=IDS)
def test_bf16_rounding_points_agree_with_jax(jx, shape, args):
    """The port rounds where the JAX package's bf16 kernel rounds. Its bf16
    output is nearer the JAX bf16 output than fp32 computed and then cast to
    bf16 is, and nearer than the contract without its normalized-plane or
    its z-weight rounding; its quantized output equals JAX's on at least
    85 % of pixels (JAX's own bf16 against fp32: 76 %). At alpha 0 its bf16
    carry (the frame's blurred grid) equals JAX's on more values than
    without the raw-cell rounding."""
    frames = noisy(B, *shape, seed=sum(shape))
    cfg, jcfg = BGConfig(*args), jx.cfg(*args)
    x = torch.from_numpy(frames)
    port = bg_fused_plain(x.to(torch.bfloat16), cfg, precision="bf16")
    assert torch.equal(_contract_bf16(x, cfg), port)
    ref = f32(jx.bg_fused(jx.np(frames), jcfg, interpret=True, precision="bf16"))

    def gap(out):
        return float(np.abs(f32(out) - ref).mean())

    controls = {
        "fp32 then cast": bg_fused_plain(x, cfg).to(torch.bfloat16),
        "no normalized-plane rounding": _contract_bf16(x, cfg, norm=False),
        "no z-weight rounding": _contract_bf16(x, cfg, zweight=False),
    }
    for what, out in controls.items():
        assert gap(port) < gap(out), (what, gap(port), gap(out))
    quant = quantize_intensity(port.float(), cfg)
    assert within_lsb(quant, quantize_intensity(torch.from_numpy(ref), cfg), lsb=1.0) >= 0.85
    assert within_lsb(quantize_intensity(controls["fp32 then cast"].float(), cfg),
                      quantize_intensity(torch.from_numpy(ref), cfg), lsb=1.0) < 0.85

    gx, gy, gz = grid_shape(*shape, cfg)
    _, jcarry = jx.bg_fused(jx.np(frames), jcfg, interpret=True, precision="bf16",
                            carry=jx.np(np.zeros((B, gx, gy, gz, 2), np.float32)).astype("bfloat16"),
                            alpha=jx.np(np.zeros(B, np.float32)))
    _, own = bg_fused_plain(x.to(torch.bfloat16), cfg, precision="bf16",
                            carry=torch.zeros((B, gx, gy, gz, 2), dtype=torch.bfloat16),
                            alpha=torch.zeros(B))
    assert torch.equal(own, _contract_bf16(x, cfg, carry=True))

    def equal_share(c):
        return float(np.mean(f32(c) == f32(jcarry)))

    assert equal_share(own) > equal_share(_contract_bf16(x, cfg, raw=False, carry=True))


def test_bf16_wrapper_takes_only_its_storage_type():
    cfg = BGConfig(4, 3.0, 50.0)
    x = torch.from_numpy(noisy(2, 19, 26))
    gx, gy, gz = grid_shape(19, 26, cfg)
    carry = torch.zeros((2, gx, gy, gz, 2))
    alpha = torch.zeros(2)
    with pytest.raises(TypeError, match="bfloat16 frames"):
        bg_fused(x, cfg, precision="bf16")
    with pytest.raises(TypeError, match="float32 frames"):
        bg_fused(x.to(torch.bfloat16), cfg)
    with pytest.raises(TypeError, match="bfloat16 carry"):
        bg_fused(x.to(torch.bfloat16), cfg, carry=carry, alpha=alpha, precision="bf16")
    with pytest.raises(TypeError, match="float32 alpha"):
        bg_fused(x.to(torch.bfloat16), cfg, carry=carry.to(torch.bfloat16),
                 alpha=alpha.to(torch.bfloat16), precision="bf16")
    with pytest.raises(ValueError, match="precision"):
        bg_fused(x, cfg, precision="fp16")


# ------------------------------------------------------------ the plans
@pytest.mark.parametrize("shape,args", CASES, ids=IDS)
def test_bf16_reference_plan_matches_jax(jx, shape, args):
    """bf16 ``"reference"`` in both packages, at the fp32 reference parity
    tolerance (atol 5e-3, tests/test_torch_core.py): both round the frames
    and filter in fp32."""
    frames = noisy(B, *shape, seed=3 * sum(shape))
    port = BGPlan(BGConfig(*args), backend="reference", precision="bf16", quantize_output=False,
                  device="cpu")(frames)
    ref = jx.plan(jx.cfg(*args), backend="reference", precision="bf16", quantize_output=False)(
        jx.np(frames))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), f32(ref), atol=5e-3, rtol=0)


@pytest.mark.parametrize("backend", ["fused", "fused_streamed"])
@pytest.mark.parametrize("shape,args", CASES, ids=IDS)
def test_bf16_reference_within_2_of_bf16_fused(shape, args, backend):
    """The port's bf16 oracle against its bf16 fused plans, the JAX
    package's tests/test_plan.py:685-690: atol 2.0, unquantized."""
    frames = noisy(B, *shape, seed=5)
    cfg = BGConfig(*args)
    ref = BGPlan(cfg, backend="reference", precision="bf16", quantize_output=False, device="cpu")
    fused = BGPlan(cfg, backend=backend, precision="bf16", quantize_output=False, device="cpu")
    out = fused(frames)
    assert out.dtype == torch.float32  # the plan upcasts the kernel's bf16 output
    np.testing.assert_allclose(ref(frames).numpy(), out.numpy(), atol=2.0, rtol=0)


@pytest.mark.parametrize("shape,args", CASES, ids=IDS)
def test_bf16_temporal_matches_jax(jx, shape, args):
    """A cold pack, then alpha (0, 0.6, 0.8) on the carry it returned, in
    each package's bf16 temporal fused plan: image atol 2.0, carries atol
    2e-2 / rtol 1.6e-2 and bf16 in both."""
    cfg, jcfg = BGConfig(*args), jx.cfg(*args)
    port = BGPlan(cfg, temporal=True, precision="bf16", quantize_output=False, device="cpu")
    jplan = jx.plan(jcfg, temporal=True, precision="bf16", quantize_output=False, interpret=True)
    gx, gy, gz = grid_shape(*shape, cfg)
    carry = torch.zeros((B, gx, gy, gz, 2), dtype=torch.bfloat16)
    jcarry = np.zeros((B, gx, gy, gz, 2), np.float32)
    for step, alpha in enumerate((np.zeros(B, np.float32), ALPHAS)):
        frames = noisy(B, *shape, seed=11 * step + 1)
        out, carry = port(frames, carry=carry, alpha=alpha)
        jout, jcarry = jplan(jx.np(frames), carry=jx.np(jcarry).astype(jplan.storage_dtype),
                             alpha=alpha)
        assert carry.dtype == torch.bfloat16 and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), f32(jout), atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(f32(carry), f32(jcarry), **CARRY_TOL)
        jcarry = f32(jcarry)


@pytest.mark.parametrize("shape,args", CASES, ids=IDS)
def test_bf16_alpha0_identity_bitwise(shape, args):
    """An alpha-0 row of a bf16 temporal call is the bf16 per-frame output
    bit for bit, and its new carry is the frame's own blurred grid in bf16."""
    cfg = BGConfig(*args)
    x = torch.from_numpy(noisy(B, *shape, seed=21)).to(torch.bfloat16)
    gx, gy, gz = grid_shape(*shape, cfg)
    warm = torch.from_numpy(np.random.default_rng(2).uniform(0.0, 40.0, (B, gx, gy, gz, 2))
                            .astype(np.float32)).to(torch.bfloat16)
    per_frame = bg_fused(x, cfg, precision="bf16")
    out, new = bg_fused(x, cfg, carry=warm, alpha=torch.from_numpy(ALPHAS), precision="bf16")
    assert torch.equal(out[0], per_frame[0]) and not torch.equal(out[1], per_frame[1])
    cold, own = bg_fused(x, cfg, carry=warm, alpha=torch.zeros(B), precision="bf16")
    assert torch.equal(cold, per_frame)
    assert torch.equal(own[0], new[0])
    # the plan's cold pack: alpha 0 on a zero carry
    plan = BGPlan(cfg, precision="bf16", quantize_output=False, device="cpu")
    o_t, _ = plan.as_temporal()(x.float(), carry=torch.zeros_like(warm), alpha=0.0)
    assert torch.equal(o_t, plan(x.float()))


def test_bf16_blurred_grid_batch_matches_jax(jx):
    """The staged oracle's bf16 axis: frames rounded, fp32 scatter and blur,
    a bf16 grid; within one bf16 ulp of the JAX package's."""
    args = (4, 3.0, 50.0)
    frames = noisy(4, 33, 47, seed=8) + np.float32(0.37)  # not bf16-exact above 128
    port = blurred_grid_batch(torch.from_numpy(frames), BGConfig(*args), precision="bf16")
    ref = jx.blurred(jx.np(frames), jx.cfg(*args), precision="bf16")
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(port), f32(ref), atol=1e-3, rtol=2.0**-8)
    assert torch.equal(blurred_grid_batch(torch.from_numpy(frames), BGConfig(*args)),
                       blurred_grid_batch(torch.from_numpy(frames), BGConfig(*args), "fp32"))


# ------------------------------------------------ fp32 byte for byte
def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(np.ascontiguousarray(t.detach().numpy()).tobytes())
    return h.hexdigest()[:16]


def _frames(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return np.clip(np.floor(rng.uniform(0, 255, (b, 1, 1)) + rng.normal(0, 30, (b, h, w)) + 0.5),
                   0, 255).astype(np.float32)


# sha256 prefixes of the fp32 plans' outputs, computed with the recipe of
# test_fp32_plans_unchanged_byte_for_byte before the bf16 storage form was
# added to the port
FP32_DIGESTS = {
    "19x26-fused-True": "37b145d0b256ab81",
    "19x26-fused-False": "b1ff64a27b045e6c",
    "19x26-fused_streamed-True": "37b145d0b256ab81",
    "19x26-fused_streamed-False": "b1ff64a27b045e6c",
    "19x26-reference-True": "37b145d0b256ab81",
    "19x26-reference-False": "f90e1ca6f3e1bbf7",
    "19x26-staged-True": "37b145d0b256ab81",
    "19x26-staged-False": "b1ff64a27b045e6c",
    "19x26-temporal-fused": "caeeb4397ce16be7",
    "19x26-temporal-reference": "cbba15c1a078f418",
    "60x96-fused-True": "eee7019e5939af77",
    "60x96-fused-False": "a12a590fcada14b8",
    "60x96-fused_streamed-True": "eee7019e5939af77",
    "60x96-fused_streamed-False": "a12a590fcada14b8",
    "60x96-reference-True": "eee7019e5939af77",
    "60x96-reference-False": "418e4f5ec66574b7",
    "60x96-staged-True": "eee7019e5939af77",
    "60x96-staged-False": "a12a590fcada14b8",
    "60x96-temporal-fused": "472dd1411b8357f7",
    "60x96-temporal-reference": "ccf6ec8c677484af",
    "37x53-fused-True": "6d7b3f4495340786",
    "37x53-fused-False": "24ad92b2d27da0bc",
    "37x53-fused_streamed-True": "6d7b3f4495340786",
    "37x53-fused_streamed-False": "24ad92b2d27da0bc",
    "37x53-reference-True": "6d7b3f4495340786",
    "37x53-reference-False": "09bc856fa42cd398",
    "37x53-staged-True": "6d7b3f4495340786",
    "37x53-staged-False": "24ad92b2d27da0bc",
    "37x53-temporal-fused": "91a5eeef97688c4a",
    "37x53-temporal-reference": "44b85192af7ce024",
}


@pytest.mark.parametrize("shape,args", CASES, ids=IDS)
def test_fp32_plans_unchanged_byte_for_byte(shape, args):
    """Every fp32 plan of the port (four backends, quantized or not, and
    both temporal routes over two chained steps) gives the bytes it gave
    before the precision plumbing."""
    h, w = shape
    cfg = BGConfig(*args)
    x = _frames(3, h, w, seed=h * w)
    got = {}
    for backend in ("fused", "fused_streamed", "reference", "staged"):
        for q in (True, False):
            got[f"{h}x{w}-{backend}-{q}"] = _digest(
                BGPlan(cfg, backend=backend, quantize_output=q, device="cpu")(x))
    gx, gy, gz = grid_shape(h, w, cfg)
    for backend in ("fused", "reference"):
        p = BGPlan(cfg, backend=backend, temporal=True, quantize_output=False, device="cpu")
        o0, c0 = p(x, carry=np.zeros((3, gx, gy, gz, 2), np.float32), alpha=np.zeros(3, np.float32))
        o1, c1 = p(_frames(3, h, w, seed=h + w), carry=c0, alpha=ALPHAS)
        assert c1.dtype == torch.float32
        got[f"{h}x{w}-temporal-{backend}"] = _digest(o0, c0, o1, c1)
    assert got == {k: v for k, v in FP32_DIGESTS.items() if k.startswith(f"{h}x{w}-")}


# every route of the plan layer: (backend, temporal, precision, mesh size;
# 0: no mesh)
EXIT_ROUTES = [
    ("fused", False, "fp32", 0), ("fused_streamed", False, "fp32", 0), ("reference", False, "fp32", 0),
    ("staged", False, "fp32", 0), ("streaming", False, "fp32", 0), ("fused", False, "bf16", 0),
    ("fused_streamed", False, "bf16", 0), ("reference", False, "bf16", 0), ("fused", True, "fp32", 0),
    ("reference", True, "fp32", 0), ("fused", True, "bf16", 0), ("reference", True, "bf16", 0),
    ("fused", False, "fp32", 3), ("fused_streamed", False, "bf16", 3), ("streaming", False, "fp32", 3),
    ("fused", True, "fp32", 3), ("fused", True, "bf16", 3),
]


@pytest.mark.parametrize("intensity_max", [255.0, 1023.0])
@pytest.mark.parametrize("backend,temporal,precision,mesh", EXIT_ROUTES,
                         ids=["-".join(map(str, r)) for r in EXIT_ROUTES])
def test_quantized_plans_keep_the_exit_formula(backend, temporal, precision, mesh, intensity_max):
    """Every route's quantized output is ``quantize_intensity`` of its
    unquantized output upcast to float32, bit for bit, as the plan computed
    it when the quantization was a pass after every route: the fused
    routes quantize in the kernels' store (each shard's kernel under a
    mesh), the others after. A bf16 plan whose range top bf16 does not hold
    (1023) quantizes after the upcast; the carry is never quantized."""
    from repro_torch.kernels.common import stores_quantized_exactly
    from repro_torch.sharding import BatchMesh

    cfg = BGConfig(4, 3.0, 50.0, intensity_max=intensity_max)
    assert stores_quantized_exactly(cfg, precision) == (precision == "fp32" or intensity_max == 255.0)
    x = _frames(5, 37, 53, seed=3) * np.float32(intensity_max / 255.0)
    kw = dict(backend=backend, temporal=temporal, precision=precision, device="cpu")
    if mesh:
        del kw["device"]
        kw["mesh"] = BatchMesh(("cpu",) * mesh)
    args = {}
    if temporal:
        rng = np.random.default_rng(5)
        args = dict(carry=rng.uniform(0.0, 4.0, (5, *grid_shape(37, 53, cfg), 2)).astype(np.float32),
                    alpha=np.asarray([0.0, 0.6, 0.8, 0.4, 0.5], np.float32))
    raw = BGPlan(cfg, quantize_output=False, **kw)(x, **args)
    got = BGPlan(cfg, quantize_output=True, **kw)(x, **args)
    if temporal:
        (raw, raw_carry), (got, carry) = raw, got
        assert torch.equal(carry, raw_carry)
    assert raw.dtype == got.dtype == torch.float32
    assert torch.equal(got, quantize_intensity(raw, cfg))
    assert (float(got.max()) > 255.0) == (intensity_max > 255.0)  # the range is used


# ------------------------------------------------------------- snapshots
def _warm_packer(precision, shape=(36, 48), steps=3):
    cfg = BGConfig(6, 4.0, 60.0)
    packer = MultiStreamPacker(plan=BGPlan(cfg, precision=precision, device="cpu"))
    for s, a in (("a", 0.4), ("b", 0.0), ("c", 0.8)):
        packer.open(s, alpha=a)
    streams = {s: noisy(steps + 1, *shape, seed=7 * i) for i, s in enumerate("abc")}
    for step in range(steps):
        packer.pack({s: streams[s][step] for s in "abc"})
    return packer, streams


def test_bf16_snapshot_round_trips_bit_for_bit():
    """export_carries gives float32 arrays holding the bf16 carries exactly;
    restoring them into a fresh bf16 packer gives the same carries and the
    same next frames, bit for bit."""
    packer, streams = _warm_packer("bf16")
    assert packer.sessions["a"].carry.dtype == torch.bfloat16
    snap = packer.export_carries()
    assert sorted(snap) == ["a", "c"]
    fresh = MultiStreamPacker(plan=packer.plan)
    for s in "abc":
        fresh.open(s, alpha=packer.sessions[s].alpha)
    for s, (carry, alpha, seen) in snap.items():
        assert carry.dtype == np.float32
        assert np.array_equal(carry, packer.sessions[s].carry.float().numpy())
        fresh.restore_carry(s, carry, alpha=alpha, frames_seen=seen)
        assert torch.equal(fresh.sessions[s].carry, packer.sessions[s].carry)
    fresh.sessions["b"].frames_seen = packer.sessions["b"].frames_seen
    nxt = {s: streams[s][3] for s in "abc"}
    a, b = packer.pack(nxt), fresh.pack(nxt)
    for s in "abc":
        assert torch.equal(a[s], b[s])
    assert all(torch.equal(packer.sessions[s].carry, fresh.sessions[s].carry) for s in "ac")
    # an fp32 snapshot restored into a bf16 packer is rounded on install
    fp32, _ = _warm_packer("fp32")
    c32 = fp32.export_carries()["a"][0]
    fresh.restore_carry("a", c32)
    assert torch.equal(fresh.sessions["a"].carry, torch.from_numpy(c32).to(torch.bfloat16))


def test_jax_bf16_snapshot_restored_into_the_port(jx):
    """Three packs through the JAX package's bf16 packer; its snapshot (ml_dtypes
    bf16 arrays) restored into the port's bf16 packer; the fourth pack agrees
    within the temporal tolerances."""
    args, shape = (6, 4.0, 60.0), (36, 48)
    jpacker = jx.packer(plan=jx.plan(jx.cfg(*args), precision="bf16", interpret=True))
    port = MultiStreamPacker(plan=BGPlan(BGConfig(*args), precision="bf16", device="cpu"))
    alphas = {"a": 0.4, "b": 0.0, "c": 0.8}
    for s, a in alphas.items():
        jpacker.open(s, alpha=a)
        port.open(s, alpha=a)
    streams = {s: noisy(4, *shape, seed=13 * i) for i, s in enumerate(alphas)}
    for step in range(3):
        jpacker.pack({s: jx.np(streams[s][step]) for s in alphas})
    snap = jpacker.export_carries()
    assert sorted(snap) == ["a", "c"]
    for s, (carry, alpha, seen) in snap.items():
        assert carry.dtype != np.float32  # the JAX package ships bf16 bytes
        port.restore_carry(s, carry, alpha=alpha, frames_seen=seen)
        assert np.array_equal(f32(port.sessions[s].carry), f32(carry))
    port.sessions["b"].frames_seen = 3
    jout = jpacker.pack({s: jx.np(streams[s][3]) for s in alphas})
    out = port.pack({s: streams[s][3] for s in alphas})
    for s in alphas:
        within_lsb(out[s], jout[s])
    for s in ("a", "c"):
        np.testing.assert_allclose(f32(port.sessions[s].carry), f32(jpacker.sessions[s].carry),
                                   **CARRY_TOL)


# --------------------------------------------------------------- quality
def test_bf16_quality_ratio_on_the_plain_versions():
    """MSSIM(bf16) / MSSIM(fp32) against the clean scenes >= 0.98 at 60x96
    (r=12, 8, 70), on the fused and streamed plans' plain versions."""
    cfg = BGConfig(12, 8.0, 70.0)
    clean = np.stack([synthetic_image_np(60, 96, seed=40 + i) for i in range(B)])
    frames = np.clip(np.floor(clean + np.random.default_rng(41).normal(0.0, 30.0, clean.shape) + 0.5),
                     0.0, 255.0).astype(np.float32)
    for backend in ("fused", "fused_streamed"):
        o32 = BGPlan(cfg, backend=backend, device="cpu")(frames)
        o16 = BGPlan(cfg, backend=backend, precision="bf16", device="cpu")(frames)
        for i in range(B):
            ref = torch.from_numpy(clean[i].astype(np.float32))
            ratio = float(mssim(ref, o16[i])) / float(mssim(ref, o32[i]))
            assert ratio >= 0.98, (backend, i, ratio)
        within_lsb(o16, o32, lsb=1.0)
