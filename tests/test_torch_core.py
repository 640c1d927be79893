"""The port's whole-image core against the JAX package's, on the same numpy
inputs.

Tolerances are the JAX package's own (tests/test_kernels.py): GC counts
exact and sums atol 1e-4, GF rtol 1e-4 / atol 1e-2, TI atol 1e-3, and the
quantized pipeline equal on >= 99.5 % of pixels with at most 1 LSB apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.bilateral_grid import quantize_intensity as j_quantize_intensity
import repro.kernels.common as JC
import repro.kernels.ref as JR
import repro_torch.core as T
import repro_torch.kernels.common as TC
import repro_torch.kernels.ref as TR

SHAPES = [(32, 32), (61, 83), (45, 200)]
PARAMS = [(2, 2.0, 30.0), (7, 4.0, 50.0), (12, 8.0, 70.0), (16, 8.0, 70.0)]


def noisy_np(h, w, seed=3, sigma=30.0):
    """Synthetic scene + numpy Gaussian noise, 8-bit quantized: the inputs
    both packages are fed."""
    clean = T.synthetic_image_np(h, w, seed=seed)
    noise = np.random.default_rng(seed + 1).normal(0.0, sigma, clean.shape)
    return np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32)


def pair(cfg_args, **kw):
    return J.BGConfig(*cfg_args, **kw), T.BGConfig(*cfg_args, **kw)


def quantized_contract(a, b):
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.mean(diff == 0.0) >= 0.995, np.mean(diff == 0.0)
    assert diff.max() <= 1.0


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("h,w", [(40, 55), (96, 128)])
def test_synthetic_image_bit_equal(h, w, seed):
    ref = np.asarray(J.synthetic_image(h, w, seed=seed))
    port = T.synthetic_image(h, w, seed=seed, device="cpu")
    assert port.dtype == torch.float32 and port.device.type == "cpu"
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(
        T.synthetic_batch(2, h, w, seed=seed, device="cpu").numpy(),
        np.asarray(J.synthetic_batch(2, h, w, seed=seed)),
    )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("params", PARAMS)
def test_grid_create_matches_jax(shape, params):
    jc, tc = pair(params)
    img = noisy_np(*shape)
    ref = np.asarray(JR.ref_create(jnp.asarray(img), jc))
    port = TR.ref_create(torch.from_numpy(img), tc).numpy()
    assert port.shape == ref.shape == J.grid_shape(*shape, jc) + (2,)
    np.testing.assert_array_equal(port[..., 0], ref[..., 0])  # counts exact
    np.testing.assert_allclose(port[..., 1], ref[..., 1], atol=1e-4)
    assert port[..., 0].sum() == shape[0] * shape[1]  # mass preserved
    np.testing.assert_allclose(port[..., 1].sum(), img.astype(np.float64).sum(), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("params", PARAMS)
def test_grid_blur_matches_jax(shape, params):
    jc, tc = pair(params)
    grid = np.asarray(JR.ref_create(jnp.asarray(noisy_np(*shape)), jc))
    ref = np.asarray(JR.ref_blur(jnp.asarray(grid), jc))
    port = TR.ref_blur(torch.tensor(grid), tc).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-2)
    assert port.min() >= 0.0


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("params", PARAMS)
def test_grid_slice_matches_jax(shape, params):
    jc, tc = pair(params)
    img = noisy_np(*shape)
    grid_f = np.asarray(J.grid_normalize(JR.ref_blur(JR.ref_create(jnp.asarray(img), jc), jc)))
    ref = np.asarray(JR.ref_slice(jnp.asarray(grid_f), jnp.asarray(img), jc))
    port = TR.ref_slice(torch.tensor(grid_f), torch.from_numpy(img), tc).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-3)
    np.testing.assert_allclose(
        TR.ref_normalize(TR.ref_blur(TR.ref_create(torch.from_numpy(img), tc), tc)).numpy(),
        grid_f, rtol=1e-4, atol=1e-3,
    )


@pytest.mark.parametrize("params,weight_mode,mode", [
    (PARAMS[1], "float", "paper"),
    (PARAMS[2], "float", "classic"),
    (PARAMS[2], "pow2", "paper"),
    (PARAMS[1], "pow2", "classic"),
])
def test_quantized_pipeline_matches_jax(params, weight_mode, mode):
    jc, tc = pair(params, normalize_mode=mode, weight_mode=weight_mode)
    img = noisy_np(61, 83)
    ref = np.asarray(J.bilateral_grid_filter(jnp.asarray(img), jc))
    port = T.bilateral_grid_filter(torch.from_numpy(img), tc).numpy()
    quantized_contract(port, ref)
    assert port.min() >= 0.0 and port.max() <= 255.0
    raw_ref = np.asarray(J.bilateral_grid_filter(jnp.asarray(img), jc, quantize_output=False))
    raw = T.bilateral_grid_filter(torch.from_numpy(img), tc, quantize_output=False).numpy()
    np.testing.assert_allclose(raw, raw_ref, atol=1e-3)


def test_constant_image_fixed_point():
    flat = torch.full((64, 64), 131.0)
    for mode in ("paper", "classic"):
        out = T.bilateral_grid_filter(flat, T.BGConfig(7, 4.0, 50.0, normalize_mode=mode))
        np.testing.assert_allclose(out.numpy(), 131.0)


def test_bg_denoises():
    clean = T.synthetic_image(96, 128, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    noisy = T.add_gaussian_noise(clean, 30.0, generator=gen)
    out = T.bilateral_grid_filter(noisy, T.BGConfig(7, 4.0, 50.0))
    assert float(T.mssim(clean, out)) > float(T.mssim(clean, noisy)) + 0.2
    assert float(T.psnr(clean, out)) > float(T.psnr(clean, noisy))


def test_add_gaussian_noise_contract():
    img = T.synthetic_image(40, 55, seed=0, device="cpu")
    a = T.add_gaussian_noise(img, 30.0, generator=torch.Generator().manual_seed(5))
    b = T.add_gaussian_noise(img, 30.0, generator=torch.Generator().manual_seed(5))
    c = T.add_gaussian_noise(img, 30.0, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, torch.floor(a)) and a.min() >= 0 and a.max() <= 255
    assert 20.0 < float((a - img).std()) < 35.0


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    a = noisy_np(48, 64, seed=seed)
    b = T.synthetic_image_np(48, 64, seed=seed)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert float(T.mssim(ta, tb)) == pytest.approx(float(J.mssim(jnp.asarray(a), jnp.asarray(b))), abs=1e-5)
    assert float(T.psnr(ta, tb)) == pytest.approx(float(J.psnr(jnp.asarray(a), jnp.asarray(b))), abs=1e-4)
    assert float(T.mssim(tb, tb)) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("weight_mode", ["float", "pow2"])
def test_config_and_helpers_match_jax(params, weight_mode):
    jc, tc = pair(params, weight_mode=weight_mode)
    assert T.grid_shape(1080, 1920, tc) == J.grid_shape(1080, 1920, jc)
    assert (tc.range_scale, tc.sigma_g, tc.gz) == (jc.range_scale, jc.sigma_g, jc.gz)
    np.testing.assert_array_equal(T.gaussian_taps(tc).numpy(), np.asarray(J.gaussian_taps(jc)))
    np.testing.assert_array_equal(TC.taps_np(tc), JC.taps_np(jc))
    r = params[0]
    assert TC.gc_row_split(r) == JC.gc_row_split(r)
    np.testing.assert_array_equal(TC.gc_col_onehot(45, 45 // r + 2, r), JC.gc_col_onehot(45, 45 // r + 2, r))
    for port, ref in zip(TC.ti_col_onehots(45, 45 // r + 2, r), JC.ti_col_onehots(45, 45 // r + 2, r)):
        np.testing.assert_array_equal(port, ref)


def test_config_validation_matches_jax():
    for bad in (dict(r=0), dict(sigma_s=0.0), dict(sigma_r=-1.0),
                dict(normalize_mode="x"), dict(weight_mode="x")):
        kw = dict(r=4, sigma_s=2.0, sigma_r=30.0) | bad
        with pytest.raises(ValueError):
            J.BGConfig(**kw)
        with pytest.raises(ValueError):
            T.BGConfig(**kw)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_conv3_axis_matches_jax(axis):
    x = np.random.default_rng(axis).uniform(0, 9, (5, 6, 7)).astype(np.float32)
    taps = (0.25, 1.0, 0.25)
    ref = np.asarray(J.conv3_axis(jnp.asarray(x), jnp.asarray(taps, jnp.float32), axis))
    np.testing.assert_allclose(T.conv3_axis(torch.from_numpy(x), taps, axis).numpy(), ref, rtol=1e-6)


def test_quantize_intensity_matches_jax():
    x = np.asarray([-3.0, -0.5, 0.49, 0.5, 1.5, 254.5, 255.2, 300.0], np.float32)
    jc, tc = pair((4, 2.0, 30.0))
    np.testing.assert_array_equal(
        T.quantize_intensity(torch.from_numpy(x), tc).numpy(),
        np.asarray(j_quantize_intensity(jnp.asarray(x), jc)),
    )


# Frames outside [0, intensity_max]: the validity guard admits any finite
# frame. jnp turns a negative grid index into index + size before its
# scatter drops, or its gather clamps, what is still out of range.
OUT_OF_RANGE = [(-60.0, 0.0), (-60.0, -50.0), (255.0, 330.0)]


@pytest.mark.parametrize("lo,hi", OUT_OF_RANGE)
@pytest.mark.parametrize("params", [(4, 2.0, 30.0), PARAMS[2]])
def test_reference_backend_matches_jax_out_of_range(params, lo, hi):
    from repro.plan import BGPlan as JPlan
    from repro_torch.plan import BGPlan as TPlan

    jc, tc = pair(params)
    frames = np.random.default_rng(11).uniform(lo, hi, (2, 37, 53)).astype(np.float32)
    ref = np.asarray(JPlan(jc, backend="reference", quantize_output=False)(jnp.asarray(frames)))
    port = TPlan(tc, backend="reference", quantize_output=False, device="cpu")(torch.from_numpy(frames))
    np.testing.assert_allclose(port.numpy(), ref, atol=5e-3, rtol=0)
    grid = TR.ref_create(torch.from_numpy(frames[0]), tc).numpy()
    j_grid = np.asarray(JR.ref_create(jnp.asarray(frames[0]), jc))
    np.testing.assert_array_equal(grid[..., 0], j_grid[..., 0])
    np.testing.assert_allclose(grid[..., 1], j_grid[..., 1], atol=1e-4)
