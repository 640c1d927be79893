"""The port's shift-only integer datapath (``repro_torch.core.fixed_point``),
exact bilateral filter and Gaussian blur (``core.bilateral_filter``)
against the JAX package's, on the same numpy inputs.

Fixed point is int32 arithmetic, so it is held bit for bit (``torch.equal``
on the output, ``pow2_shift`` and the LUTs equal), inputs outside [0, 255]
included. The BF and the blur are float: atol 1e-3 unquantized and the
quantized contract (>= 99.5 % of pixels equal, at most 1 LSB apart,
tests/test_kernels.py:100-101), since ``exp`` may differ by an ulp between
XLA and torch."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.configs.bg_denoise import FIG12_SWEEPS, SERVE_CONFIG, TABLE1_SWEEP

H, W = 64, 96


def noisy_np(shape, seed=3, sigma=30.0):
    *b, h, w = shape
    clean = np.stack([T.synthetic_image_np(h, w, seed=seed + i) for i in range(int(np.prod(b)))])
    noise = np.random.default_rng(seed + 50).normal(0.0, sigma, clean.shape)
    return np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32).reshape(shape)


def quantized_contract(a, b):
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.mean(diff == 0.0) >= 0.995, np.mean(diff == 0.0)
    assert diff.max() <= 1.0


def jcfg(cfg: T.BGConfig) -> J.BGConfig:
    return J.BGConfig(**dataclasses.asdict(cfg))


CONFIGS = [wl.bg for wl in TABLE1_SWEEP] + [SERVE_CONFIG] + list(FIG12_SWEEPS["sigma_s"])


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"r{c.r}-s{c.sigma_s}-{c.sigma_r}")
def test_shift_and_luts_equal_jax(cfg):
    assert T.pow2_shift(cfg) == J.pow2_shift(jcfg(cfg))
    for mine, theirs in zip(T.intensity_luts(cfg), J.intensity_luts(jcfg(cfg))):
        assert mine.dtype == theirs.dtype == np.int32
        np.testing.assert_array_equal(mine, theirs)


def _fixed_pair(x, cfg):
    mine = T.bilateral_grid_filter_fixed(x, cfg, device="cpu")
    theirs = np.array(J.bilateral_grid_filter_fixed(jnp.asarray(x), jcfg(cfg)))
    return mine, theirs


@pytest.mark.parametrize("r", [4, 8, 12, 16])
def test_fixed_point_bit_for_bit(r):
    cfg = T.BGConfig(r, 8.0, 70.0, weight_mode="pow2")
    x = noisy_np((H, W))
    mine, theirs = _fixed_pair(x, cfg)
    assert mine.dtype == torch.float32 and mine.shape == (H, W)
    assert torch.equal(mine, torch.from_numpy(theirs))
    # the JAX package's own check against the pow2 float path
    # (tests/test_core_bg.py:116-126), here on the port's side
    ref = T.bilateral_grid_filter(torch.from_numpy(x), cfg)
    diff = (ref - mine).abs()
    assert float((diff <= 1.0).float().mean()) > 0.99 and float(diff.max()) <= 4.0


@pytest.mark.parametrize("args", [(6, 4.0, 60.0), (2, 1.0, 30.0), (5, 0.1, 50.0), (2, 2.0, 85.014)])
def test_fixed_point_out_of_range_and_top_bin(args):
    """Inputs outside [0, 255] (negative ones wrap once in the LUT gather,
    then clamp) and fractional inputs (truncated toward zero). sigma_s =
    0.1 underflows the tap (k = 31: no neighbour). At sigma_r = 85.014 the
    LUT carries level 255 into z0 = gz - 1, so TI's z0 + 1 is past the grid
    and clamps, as JAX's gather clamps it."""
    cfg = T.BGConfig(*args, weight_mode="pow2")
    if args[2] == 85.014:
        assert T.intensity_luts(cfg)[0][-1] + 1 == cfg.gz
    x = noisy_np((37, 53), seed=8)
    x[0, :12] = [-300.0, -257.0, -256.0, -255.5, -5.0, -0.5, 255.0, 255.5, 256.0, 300.0, 511.0, 1e4]
    x[1:4] = 255.0
    x[4, :10] = np.linspace(0.25, 250.75, 10)
    mine, theirs = _fixed_pair(x, cfg)
    assert torch.equal(mine, torch.from_numpy(theirs))


def test_fixed_point_radius_bound():
    cfg = T.BGConfig(32, 8.0, 70.0, weight_mode="pow2")
    with pytest.raises(ValueError, match="r <= 31"):
        T.bilateral_grid_filter_fixed(noisy_np((40, 40)), cfg, device="cpu")
    with pytest.raises(ValueError, match="r <= 31"):
        J.bilateral_grid_filter_fixed(jnp.asarray(noisy_np((40, 40))), jcfg(cfg))


@pytest.mark.parametrize("r,ss,sr", [(1, 2.0, 30.0), (3, 4.0, 50.0), (5, 3.0, 70.0)])
def test_bilateral_filter_matches_jax(r, ss, sr):
    x = noisy_np((40, 56))
    raw = T.bilateral_filter(x, r, ss, sr, quantize_output=False, device="cpu")
    jraw = np.asarray(J.bilateral_filter(jnp.asarray(x), r, ss, sr, quantize_output=False))
    np.testing.assert_allclose(raw.numpy(), jraw, atol=1e-3)
    q = T.bilateral_filter(x, r, ss, sr, device="cpu")
    quantized_contract(q.numpy(), np.asarray(J.bilateral_filter(jnp.asarray(x), r, ss, sr)))


def test_bilateral_filter_batch_rows_equal_single_frames():
    x = noisy_np((3, 30, 41), seed=4)
    out = T.bilateral_filter(x, 3, 4.0, 50.0, quantize_output=False, device="cpu")
    assert out.shape == x.shape
    for i in range(3):
        assert torch.equal(out[i], T.bilateral_filter(x[i], 3, 4.0, 50.0, quantize_output=False,
                                                      device="cpu"))
        np.testing.assert_allclose(
            out[i].numpy(),
            np.asarray(J.bilateral_filter(jnp.asarray(x[i]), 3, 4.0, 50.0, quantize_output=False)),
            atol=1e-3,
        )


@pytest.mark.parametrize("r,sigma", [(1, 0.8), (3, 2.0), (6, 4.0)])
def test_gaussian_blur_matches_jax(r, sigma):
    x = noisy_np((2, 33, 47), seed=6)
    out = T.gaussian_blur(x, r, sigma, device="cpu")
    assert out.shape == x.shape
    for i in range(2):
        np.testing.assert_allclose(
            out[i].numpy(), np.asarray(J.gaussian_blur(jnp.asarray(x[i]), r, sigma)), atol=1e-3
        )
        assert torch.equal(out[i], T.gaussian_blur(x[i], r, sigma, device="cpu"))
