"""Card twins of ``chip_smoke.py``'s ``core_paths`` phase, at small sizes:
the streaming backend, fixed point, the exact BF and the frontends on the
CUDA card against the port's plain results on the CPU, and the z bin at a
bin edge (ROADMAP C4) on both. The ``gpu``-marked tests skip without a
card; the file imports no JAX, so it runs on the card's host (``pytest -m
gpu tests/test_torch_core_paths.py``). The CPU tests against the JAX
package are in ``test_torch_streaming.py``, ``test_torch_fixed_point.py``
and ``test_torch_data.py``."""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.data as TD
from repro_torch.plan import BGPlan, plan_for

ATOL = 1e-3
CFG = T.BGConfig(4, 3.0, 50.0)


def noisy_np(shape, seed=3, sigma=30.0):
    *b, h, w = shape
    clean = np.stack([T.synthetic_image_np(h, w, seed=seed + i) for i in range(int(np.prod(b)))])
    noise = np.random.default_rng(seed + 50).normal(0.0, sigma, clean.shape)
    return np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32).reshape(shape)


def quantized_contract(a, b):
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.mean(diff == 0.0) >= 0.995, np.mean(diff == 0.0)
    assert diff.max() <= 1.0


@pytest.fixture
def cuda():
    """The CUDA device; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def edge_frames(n=2, h=64, w=96, seed=31):
    """8-bit noisy frames mapped to dB and min-max scaled back, as
    ``spectrogram_denoise`` scales them: values a few ulps from the
    integers, some just below a z-bin edge."""
    x = noisy_np((n, h, w), seed=seed) / 255.0 * 80.0 - 80.0
    return torch.from_numpy((x - x.min()) / (x.max() - x.min()) * 255.0)


# grids whose bin edges (k + 1/2) * rs are integers that the frames reach
EDGE_CONFIGS = [(4, 2.0, 40.0), (12, 6.0, 80.0)]


@pytest.mark.parametrize("args", EDGE_CONFIGS)
def test_plain_kernels_bin_as_the_reference_at_bin_edges(args):
    """Every z bin divides, ``floor(px / rs + 0.5)``, the reference's rule:
    the kernels' plain versions fill the reference's bins on frames where a
    product with ``fp32(1/rs)`` would bin pixels apart, and the fused plain
    version stays within the quantized contract of the reference."""
    from repro_torch.kernels import bg_create_plain, bg_fused_plain

    cfg = T.BGConfig(*args)
    x = edge_frames()
    product = torch.floor(x * float(np.float32(1.0 / cfg.range_scale)) + 0.5)
    division = torch.floor(x / cfg.range_scale + 0.5)
    assert int((product != division).sum()) > 0  # the frames reach a bin edge
    counts = bg_create_plain(x, cfg)[..., 0]
    assert torch.equal(counts, torch.stack([T.grid_create(f, cfg)[..., 0] for f in x]))
    quantized_contract(T.quantize_intensity(bg_fused_plain(x, cfg), cfg).numpy(),
                       BGPlan(cfg, backend="reference", device="cpu")(x).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("args", EDGE_CONFIGS)
def test_kernels_bin_as_the_reference_at_bin_edges_on_card(cuda, args):
    """B4's counts equal its plain version's and the reference's on the
    card, and B1 and B3 equal their plain version within the fused
    tolerance, on frames at a z-bin edge."""
    from repro_torch.kernels import bg_create, bg_create_plain, bg_fused, bg_fused_plain

    cfg = T.BGConfig(*args)
    x = edge_frames().to(cuda)
    counts = bg_create(x, cfg)[..., 0]
    assert torch.equal(counts, bg_create_plain(x, cfg)[..., 0])
    assert torch.equal(counts.cpu(), torch.stack([T.grid_create(f, cfg)[..., 0] for f in x.cpu()]))
    plain = bg_fused_plain(x, cfg)
    b1 = bg_fused(x, cfg)
    assert float((b1 - plain).abs().max()) <= 5e-3
    assert torch.equal(bg_fused(x, cfg, stream_input=True), b1)


def near_edges(cfg, ulps=256, w=96):
    """A frame of every float32 in [0, intensity_max] within ``ulps`` of a
    z-bin edge (k + 1/2) * rs of ``cfg``, in rows of ``w`` pixels, the last
    row filled with 100. (Outside the range the kernels drop a negative bin
    where the reference wraps it first: ROADMAP C, notes.)"""
    rs = float(np.float32(cfg.range_scale))
    vals = []
    for k in range(cfg.gz):
        edge = np.float32((k + 0.5) * rs)
        vals.append((edge.view(np.int32) + np.arange(-ulps, ulps + 1, dtype=np.int32)).view(np.float32))
    vals = np.concatenate(vals)
    vals = vals[(vals >= 0.0) & (vals <= cfg.intensity_max)]
    frame = np.full((-(-vals.size // w), w), 100.0, np.float32)
    frame.reshape(-1)[: vals.size] = vals
    return torch.from_numpy(frame)[None]


def _round32(exact):
    """A ``Fraction`` rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    near = np.float32(float(exact))
    cands = (near, np.nextafter(near, np.float32(np.inf)), np.nextafter(near, np.float32(-np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact), int(c.view(np.int32)) & 1))


def _fma32(a, b, c):
    from fractions import Fraction

    return _round32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


@pytest.mark.parametrize("args", EDGE_CONFIGS + [(4, 3.0, 50.0), (7, 4.0, 50.0), (12, 8.0, 70.0),
                                                 (6, 4.0, 60.0), (2, 4.0, 50.0), (16, 8.0, 70.0),
                                                 (9, 4.0, 50.0)])
def test_markstein_quotient_is_the_division(args):
    """``bg::gc_bin``'s quotient, emulated exactly: q = px * rcp rounded,
    the residual px - q * rs and q + residual * rcp each one FMA rounded
    once, with rcp the correctly rounded 1/rs, equals the float32 division
    px / rs (correctly rounded) on every float32 within 24 ulps of every
    z-bin edge, and on random inputs."""
    cfg = T.BGConfig(*args)
    rs = np.float32(cfg.range_scale)
    rcp = np.float32(1.0) / rs
    vals = [(np.float32((k + 0.5) * float(rs)).view(np.int32) + np.arange(-24, 25, dtype=np.int32))
            .view(np.float32) for k in range(-2, cfg.gz + 1)]
    vals.append(np.random.default_rng(int(rs)).uniform(-400.0, 400.0, 300).astype(np.float32))
    for px in np.concatenate(vals):
        q = px * rcp
        assert _fma32(_fma32(-q, rs, px), rcp, q) == px / rs, px


@pytest.mark.gpu
@pytest.mark.parametrize("args", EDGE_CONFIGS + [(4, 3.0, 50.0), (7, 4.0, 50.0), (12, 8.0, 70.0)])
def test_kernel_bins_equal_the_division_near_every_edge_on_card(cuda, args):
    """``bg::gc_bin``'s Markstein quotient gives the division's bin for
    every float32 within 256 ulps of every z-bin edge: B4's counts equal
    the reference's (which divides on the CPU) and its plain version's,
    B1 equals its plain version within the fused tolerance and B3 equals
    B1 bit for bit."""
    from repro_torch.kernels import bg_create, bg_create_plain, bg_fused, bg_fused_plain

    cfg = T.BGConfig(*args)
    x = near_edges(cfg)
    counts = bg_create(x.to(cuda), cfg)[..., 0]
    assert torch.equal(counts.cpu(), T.grid_create(x[0], cfg)[..., 0][None])
    assert torch.equal(counts, bg_create_plain(x.to(cuda), cfg)[..., 0])
    b1 = bg_fused(x.to(cuda), cfg)
    assert float((b1 - bg_fused_plain(x.to(cuda), cfg)).abs().max()) <= 5e-3
    assert torch.equal(bg_fused(x.to(cuda), cfg, stream_input=True), b1)


def port(frames, args, mode, quantize, backend="streaming"):
    tc = T.BGConfig(*args, normalize_mode=mode)
    return BGPlan(tc, backend=backend, quantize_output=quantize, device="cpu")(frames).numpy()


@pytest.mark.gpu
def test_streaming_plan_on_card_matches_reference(cuda):
    """The card's check of chip_smoke.py's core_paths phase at a small size:
    the streaming plan on the card against the reference plan (atol 1e-3
    unquantized, the quantized contract) and against the port's CPU run."""
    x = noisy_np((2, 61, 83), seed=9)
    cfg = T.BGConfig(5, 4.0, 50.0)
    raw = BGPlan(cfg, backend="streaming", quantize_output=False, device=cuda)(x)
    assert raw.is_cuda and raw.shape == x.shape
    ref = BGPlan(cfg, backend="reference", quantize_output=False, device=cuda)(x)
    assert float((raw - ref).abs().max()) <= ATOL
    np.testing.assert_allclose(raw.cpu().numpy(), port(x, (5, 4.0, 50.0), "paper", False), atol=ATOL)
    q = BGPlan(cfg, backend="streaming", device=cuda)(x)
    quantized_contract(q.cpu().numpy(), BGPlan(cfg, backend="reference", device=cuda)(x).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("args", EDGE_CONFIGS)
def test_reference_grid_on_card_equals_cpu_at_bin_edges(cuda, args):
    """The reference divides by the range scale on the card as on the CPU:
    frames a few ulps below a z-bin edge (an 8-bit picture through a
    float scaling) fill the same bins on both."""
    x = edge_frames()
    cfg = T.BGConfig(*args)
    for frame in x:
        card = T.grid_create(frame.to(cuda), cfg)
        assert torch.equal(card[..., 0].cpu(), T.grid_create(frame, cfg)[..., 0])
    card = BGPlan(cfg, backend="reference", device=cuda)(x)
    quantized_contract(card.cpu().numpy(), BGPlan(cfg, backend="reference", device="cpu")(x).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("r", [4, 16])
def test_fixed_point_on_card_equals_cpu(cuda, r):
    """Integer sums do not depend on order: the card's int32 scatter gives
    the CPU's bits (chip_smoke.py's core_paths phase at full HD)."""
    cfg = T.BGConfig(r, 8.0, 70.0, weight_mode="pow2")
    x = noisy_np((135, 241), seed=2)
    x[0, :4] = [-20.0, -300.0, 256.0, 400.0]
    card = T.bilateral_grid_filter_fixed(torch.from_numpy(x).to(cuda), cfg)
    assert card.is_cuda
    assert torch.equal(card.cpu(), T.bilateral_grid_filter_fixed(x, cfg, device="cpu"))


@pytest.mark.gpu
def test_bilateral_filter_on_card_matches_cpu(cuda):
    x = noisy_np((2, 67, 90), seed=12)
    card = T.bilateral_filter(torch.from_numpy(x).to(cuda), 4, 8.0, 70.0, quantize_output=False)
    cpu = T.bilateral_filter(x, 4, 8.0, 70.0, quantize_output=False, device="cpu")
    assert card.is_cuda and float((card.cpu() - cpu).abs().max()) <= 1e-3
    blur = T.gaussian_blur(torch.from_numpy(x).to(cuda), 3, 2.0)
    assert float((blur.cpu() - T.gaussian_blur(x, 3, 2.0, device="cpu")).abs().max()) <= 1e-3


def launches_of(call):
    """(result, {counter: launches}) of ``call()``, the counters that moved."""
    from repro_torch.kernels import launch_counts

    before = launch_counts()
    out = call()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


KERNEL_COUNTER = {"fused": "bg_fused.launches", "fused_streamed": "bg_fused.streamed_launches"}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 8])
def test_vlm_frontend_launches_the_plan_kernel_on_card(cuda, n):
    """``plan_for``'s plan on the card: B3 or B1 launches equal to the
    plan's dispatches and no other counter moves (chip_smoke.py's
    core_paths phase at a small size), the frames within the quantized
    contract of the reference plan."""
    h, w = 90, 160
    x = noisy_np((n, h, w), seed=30)
    plan = plan_for(CFG, h, w, n_frames=n, cache=False, device=cuda)
    emb, moved = launches_of(lambda: TD.vlm_preprocess(x, None, 8, 16, plan=plan))
    assert moved == {KERNEL_COUNTER[plan.backend]: -(-n // plan.tile_for(n))}
    assert emb.is_cuda and emb.shape == (n, (h // 8) * (w // 8), 16)
    den = TD.denoise_batch(x, plan=plan)
    ref = BGPlan(CFG, backend="reference", device=cuda)(x)
    quantized_contract(den.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 8])
def test_spectrogram_frontend_on_card(cuda, n):
    """The audio frontend on ``plan_for``'s plan on the card: one launch of
    B3 or B1 per dispatch, and the output within one intensity level of the
    reference plan's on 99.5 % of pixels, on the card and on the CPU. The
    spectrogram is an 8-bit picture scaled to dB, so its min-max scaling
    gives values within a few ulps of integers, some at a z-bin edge
    (ROADMAP C4: before PR 21 the kernels binned those apart)."""
    audio = T.BGConfig(4, 2.0, 40.0)
    spec = torch.from_numpy(noisy_np((n, 64, 96), seed=31) / 255.0 * 80.0 - 80.0)
    plan = plan_for(audio, 64, 96, n_frames=n, cache=False, device=cuda)
    out, moved = launches_of(lambda: TD.spectrogram_denoise(spec, plan=plan))
    assert moved == {KERNEL_COUNTER[plan.backend]: -(-n // plan.tile_for(n))}
    level = float(spec.max() - spec.min()) / 255.0
    refs = {"card": TD.spectrogram_denoise(spec, plan=BGPlan(audio, backend="reference", device=cuda)),
            "cpu": TD.spectrogram_denoise(spec, audio, device="cpu")}
    for where, ref in refs.items():
        diff = (out.cpu() - ref.cpu()).abs() / level
        share, most = float((diff <= 1e-3).float().mean()), float(diff.max())
        assert share >= 0.995 and most <= 1.0 + 1e-3, (where, share, most)
