"""The staged kernels of the port (GC, GF and TI with the grid in HBM) and
the ``"staged"`` backend, against the JAX package on the same numpy frames.

On the CPU each wrapper runs its plain version; it is held to the JAX
package's staged Pallas kernels (interpret mode) at the JAX package's own
tolerances (tests/test_kernels.py): GC atol 1e-4 with counts summing to
h*w, GF rtol 1e-4 / atol 1e-2, TI atol 1e-3, and the staged backend's
quantized output at >= 99.5 % exact / <= 1 LSB. The tests marked ``gpu``
run the CUDA kernels and skip without a card; there GC (B4) is held to its
plain version bit for bit, and B5 of B4's grid to the fused kernel's
blurred grid bit for bit:

    pytest -m gpu tests/test_torch_staged.py
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.bg_denoise import FIG12_SWEEPS, PAPER_DEFAULT, SERVE_CONFIG, TABLE1_SWEEP
from repro_torch.core import BGConfig, grid_normalize, synthetic_image_np
from repro_torch.kernels import (
    bg_blur,
    bg_blur_plain,
    bg_create,
    bg_create_plain,
    bg_fused,
    bg_slice,
    bg_slice_plain,
    bilateral_grid_filter_pallas,
)
from repro_torch.kernels import bg_blur as B5
from repro_torch.kernels.bg_blur import blur_geometry, blur_smem_bytes
from repro_torch.kernels.bg_create import CreateGeometry, create_geometry, create_smem_bytes
from repro_torch.kernels.bg_create import ring_rows as create_ring_rows
from repro_torch.kernels.bg_slice import SliceGeometry, slice_geometry, slice_smem_bytes
from repro_torch.kernels.common import grid_shape
from repro_torch.plan import BGPlan

SHAPES = [(40, 55), (60, 96)]
PARAMS = [(5, 3.0, 40.0), (6, 4.0, 60.0), (8, 8.0, 70.0)]


def noisy_np(*shape, seed=11):
    """(h, w) or (b, h, w) synthetic scenes + numpy noise, 8-bit quantized."""
    h, w = shape[-2:]
    b = shape[0] if len(shape) == 3 else 1
    clean = np.stack([synthetic_image_np(h, w, seed=seed + i) for i in range(b)])
    noise = np.random.default_rng(seed + 100).normal(0.0, 30.0, clean.shape)
    out = np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32)
    return out.reshape(shape)


def quantized_contract(a, b):
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.mean(diff == 0.0) >= 0.995, np.mean(diff == 0.0)
    assert diff.max() <= 1.0


@pytest.fixture
def jx():
    """The JAX package's staged kernels, oracles and plan. The card's host
    has no JAX, so ``pytest -m gpu`` there must not import it."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import BGConfig as JBGConfig
    from repro.core.bilateral_grid import grid_normalize as j_normalize
    from repro.kernels import bg_blur as j_blur
    from repro.kernels import bg_create as j_create
    from repro.kernels import bg_slice as j_slice
    from repro.kernels.ref import ref_blur, ref_create
    from repro.plan import BGPlan as JBGPlan

    return SimpleNamespace(
        np=jnp.asarray, cfg=JBGConfig, create=j_create, blur=j_blur, slice=j_slice,
        normalize=j_normalize, ref_create=ref_create, ref_blur=ref_blur, plan=JBGPlan,
    )


@pytest.fixture
def cuda():
    """The CUDA device; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


# ------------------------------------------------------------ CPU: parity
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("params", PARAMS)
def test_create_matches_jax_kernel(jx, shape, params):
    img = noisy_np(*shape)
    port = bg_create(torch.from_numpy(img), BGConfig(*params))
    kernel = np.asarray(jx.create(jx.np(img), jx.cfg(*params), interpret=True))
    assert tuple(port.shape) == kernel.shape and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), kernel, atol=1e-4)
    assert float(port[..., 0].sum()) == shape[0] * shape[1]


def test_create_batch_rows_equal_single_frames():
    cfg = BGConfig(*PARAMS[0])
    imgs = torch.from_numpy(noisy_np(3, 40, 55))
    batch = bg_create(imgs, cfg)
    assert batch.shape == (3,) + bg_create(imgs[0], cfg).shape
    for i in range(3):
        assert torch.equal(batch[i], bg_create(imgs[i].clone(), cfg))
    assert torch.equal(batch, bg_create_plain(imgs, cfg))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("params", PARAMS)
def test_blur_matches_jax_kernel(jx, shape, params):
    img = noisy_np(*shape)
    grid = np.array(jx.ref_create(jx.np(img), jx.cfg(*params)))
    port = bg_blur(torch.from_numpy(grid), BGConfig(*params))
    kernel = np.asarray(jx.blur(jx.np(grid), jx.cfg(*params), interpret=True))
    assert tuple(port.shape) == kernel.shape
    np.testing.assert_allclose(port.numpy(), kernel, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("params", PARAMS)
def test_slice_matches_jax_kernel(jx, shape, params):
    img = noisy_np(*shape)
    jcfg = jx.cfg(*params)
    gf = np.array(jx.normalize(jx.ref_blur(jx.ref_create(jx.np(img), jcfg), jcfg)))
    port = bg_slice(torch.from_numpy(gf), torch.from_numpy(img), BGConfig(*params))
    kernel = np.asarray(jx.slice(jx.np(gf), jx.np(img), jcfg, interpret=True))
    assert tuple(port.shape) == shape
    np.testing.assert_allclose(port.numpy(), kernel, atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_staged_backend_matches_jax_staged(jx, shape):
    cfg_args = PARAMS[1]
    frames = noisy_np(2, *shape, seed=4)
    ref = np.asarray(jx.plan(jx.cfg(*cfg_args), backend="staged", interpret=True)(frames))
    plan = BGPlan(BGConfig(*cfg_args), backend="staged", device="cpu")
    quantized_contract(plan(frames).numpy(), ref)
    kw = bilateral_grid_filter_pallas(
        torch.from_numpy(frames), BGConfig(*cfg_args), fused=False, device="cpu"
    )
    quantized_contract(kw.numpy(), ref)
    assert torch.equal(kw, plan(frames))


def test_staged_backend_matches_fused_backend():
    cfg = BGConfig(*PARAMS[2])
    frames = noisy_np(3, 60, 96, seed=8)
    staged = BGPlan(cfg, backend="staged", device="cpu")(frames)
    fused = BGPlan(cfg, backend="fused", device="cpu")(frames)
    quantized_contract(staged.numpy(), fused.numpy())
    raw = BGPlan(cfg, backend="staged", quantize_output=False, device="cpu")(frames[0])
    np.testing.assert_allclose(raw.numpy(), bg_fused(torch.from_numpy(frames[0]), cfg).numpy(), atol=5e-3)


def test_staged_wrappers_reject_what_the_kernels_do_not_take():
    cfg = BGConfig(*PARAMS[1])
    img = torch.from_numpy(noisy_np(2, 40, 55))
    grid = bg_create(img, cfg)
    with pytest.raises(TypeError, match="float32"):
        bg_create(img.double(), cfg)
    with pytest.raises(ValueError, match="frames"):
        bg_create(torch.zeros(1, 2, 12, 12), cfg)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bg_create(img.to("meta"), cfg)
    with pytest.raises(TypeError, match="float32"):
        bg_blur(grid.double(), cfg)
    with pytest.raises(ValueError, match="grid"):
        bg_blur(grid[..., :1], cfg)
    gf = grid_normalize(bg_blur(grid, cfg))
    with pytest.raises(ValueError, match="grid"):
        bg_slice(gf[:, :-1], img, cfg)
    with pytest.raises(ValueError, match="grid"):
        bg_slice(gf, img[0], cfg)
    assert bg_slice(gf[1], img[1], cfg).shape == (40, 55)


H100_SMS, H100_SMEM_OPTIN = 132, 232448
FULL_HD = [(f"table1-r{wl.bg.r}", wl.bg) for wl in TABLE1_SWEEP] + [("serve", SERVE_CONFIG)]


@pytest.mark.parametrize("name,cfg", FULL_HD)
def test_create_geometry_fills_the_card_at_full_hd(name, cfg):
    """B4's band of planes, column tile and z group at the five full-HD
    grids, at b = 1 and 8: the block fits the card's shared memory, bands
    and tiles cover the grid, a tile is at most one task per thread, and
    every one of the 132 SMs gets a block (at least one full wave)."""
    gx, gy, gz = grid_shape(1080, 1920, cfg)
    for b in (1, 8):
        geo = create_geometry(b, 1080, 1920, cfg, H100_SMS, H100_SMEM_OPTIN)
        assert isinstance(geo, CreateGeometry)
        assert 1 <= geo.band <= gx and geo.bands == -(-gx // geo.band)
        assert 1 <= geo.tile <= gy and geo.tiles == -(-gy // geo.tile)
        assert geo.zgroup in (1, 2, 4)
        assert geo.ring_rows == create_ring_rows(cfg.r, geo.band) and geo.ring_rows % 4 == 0
        assert geo.smem == create_smem_bytes(geo.tile, cfg.r, geo.ring_rows) <= H100_SMEM_OPTIN
        assert b * geo.bands * geo.tiles >= H100_SMS, (b, geo)
        assert geo.tile * -(-gz // geo.zgroup) <= 256


def test_create_geometry_rules():
    cfg = PAPER_DEFAULT.bg  # grid 92 x 162 x 4
    geo = lambda b, **kw: create_geometry(b, 1080, 1920, cfg, H100_SMS, H100_SMEM_OPTIN, **kw)
    # an mbarrier; the z bin bytes, r rows of tile * r to a multiple of 4,
    # to 16 bytes; a ring row, tile * r floats + 3 to a multiple of 4, + 3
    assert create_ring_rows(12, 1) == 12 and create_ring_rows(12, 2) == 24 and create_ring_rows(5, 3) == 12
    assert create_smem_bytes(54, 12, 24) == 16 + 12 * 648 + 24 * (652 + 3) * 4 == 70672
    # tasks of 2 z bins; 128 cells halved to 64 (4 blocks of one plane per
    # SM), evened to 54; one frame cuts finer tiles, 41 cells (368 blocks);
    # a band of one plane (7776 pixels of the tile)
    assert geo(1) == (1, 92, 41, 4, 2, 12, 29872)
    assert geo(4) == (1, 92, 54, 3, 2, 12, 39232)
    assert geo(8) == (1, 92, 54, 3, 2, 12, 39232)
    # r=2: planes of 2 rows, so a band holds 48 of them, with a ring of two
    assert create_geometry(1, 1080, 1920, FIG12_SWEEPS["r"][0], H100_SMS, H100_SMEM_OPTIN)[:7] == \
        (48, 12, 42, 23, 2, 4, 1648)


@pytest.mark.parametrize("knobs,want", [
    # explicit knobs are cut to the grid, as stream_geometry's are
    (dict(band=500, tile=1000, zgroup=4), (92, 1, 162, 1, 4, 24)),
    (dict(band=0, tile=0, zgroup=2), (1, 92, 1, 162, 2, 12)),
    (dict(band=7, tile=5), (7, 14, 5, 33, 2, 24)),
])
def test_create_geometry_knobs_are_clamped(knobs, want):
    geo = create_geometry(1, 1080, 1920, PAPER_DEFAULT.bg, H100_SMS, H100_SMEM_OPTIN, **knobs)
    assert geo[:6] == want
    assert geo.smem == create_smem_bytes(geo.tile, 12, geo.ring_rows) <= H100_SMEM_OPTIN


def test_create_geometry_cuts_what_does_not_fit():
    cfg = TABLE1_SWEEP[3].bg  # r=16: a whole row of 122 cells
    one, two = create_smem_bytes(122, 16, 16), create_smem_bytes(122, 16, 32)
    assert one < H100_SMEM_OPTIN < two
    # a two-plane ring that does not fit: a band of one plane
    geo = create_geometry(8, 1080, 1920, cfg, H100_SMS, H100_SMEM_OPTIN, tile=122, band=4)
    assert (geo.tile, geo.band, geo.smem) == (122, 1, one)
    # a one-plane ring that does not fit: the tile is halved until it does
    geo = create_geometry(8, 1080, 1920, cfg, H100_SMS, one - 1, tile=122, band=1)
    assert geo.tile == 61 and geo.smem == create_smem_bytes(61, 16, 16) < one


@pytest.mark.parametrize("cfg,limit,match", [
    (BGConfig(4, 4.0, 1.0), H100_SMEM_OPTIN, "gz=257"),  # a bin is a byte
    (PAPER_DEFAULT.bg, 1000, f"{create_smem_bytes(1, 12, 12)} bytes"),  # one cell does not fit
])
def test_create_geometry_raises(cfg, limit, match):
    with pytest.raises(ValueError, match=match):
        create_geometry(1, 1080, 1920, cfg, H100_SMS, limit)
    with pytest.raises(ValueError, match="zgroup"):
        create_geometry(1, 1080, 1920, PAPER_DEFAULT.bg, H100_SMS, H100_SMEM_OPTIN, zgroup=3)


@pytest.mark.parametrize("name,cfg", FULL_HD)
def test_blur_geometry_fills_the_card_at_full_hd(name, cfg):
    """B5's run of x-planes and y tile at the five full-HD grids: the block
    fits, runs and tiles cover the grid, and b = 1, 4, 8 give at least one
    block per SM."""
    gx, gy, gz = grid_shape(1080, 1920, cfg)
    for b in (1, 4, 8):
        run, runs, ytile, ytiles, smem = blur_geometry(b, gx, gy, gz, H100_SMS, H100_SMEM_OPTIN)
        assert 1 <= run <= gx and runs == -(-gx // run)
        assert 1 <= ytile <= gy and ytiles == -(-gy // ytile)
        assert smem == blur_smem_bytes(ytile, gz) <= H100_SMEM_OPTIN
        assert b * runs * ytiles >= H100_SMS


def test_blur_geometry_rules():
    gx, gy, gz = grid_shape(1080, 1920, PAPER_DEFAULT.bg)  # 92 x 162 x 4
    geo = lambda b, **kw: blur_geometry(b, gx, gy, gz, H100_SMS, H100_SMEM_OPTIN, **kw)
    # a plane tile is (ytile + 2) * gz * 2 floats; five of them per block
    assert blur_smem_bytes(162, 4) == 5 * 164 * 8 * 4 == 26240
    assert geo(8) == (2, 46, 162, 1, 26240)
    assert geo(4) == (1, 92, 162, 1, 26240)
    assert geo(1) == (1, 92, 54, 3, 8960)  # too few planes: y tiles instead
    # explicit knobs are cut to the grid; a run longer than gx is one run
    assert geo(1, run=500, ytile=1000) == (92, 1, 162, 1, 26240)
    # r=2 at full HD: a whole plane does not fit, the tile is cut to what does
    r2 = FIG12_SWEEPS["r"][0]
    g2 = grid_shape(1080, 1920, r2)
    assert blur_smem_bytes(g2[1], r2.gz) > H100_SMEM_OPTIN
    run, runs, ytile, ytiles, smem = blur_geometry(8, *g2, H100_SMS, H100_SMEM_OPTIN)
    assert ytiles > 1 and smem <= H100_SMEM_OPTIN < blur_smem_bytes(ytile + 1, r2.gz)
    need = blur_smem_bytes(1, 3000)
    with pytest.raises(ValueError, match=f"{need} bytes"):
        blur_geometry(1, 4, 4, 3000, H100_SMS, H100_SMEM_OPTIN)


@pytest.mark.parametrize("name,cfg", FULL_HD)
def test_slice_geometry_fills_the_card_at_full_hd(name, cfg):
    """B6's band of stripes and column tile at the five full-HD configs: one
    column per thread, bands and tiles that cover the frame, and one frame
    alone at least four blocks per SM."""
    n, nc = -(-1080 // cfg.r), -(-1920 // cfg.r)
    gz = grid_shape(1080, 1920, cfg)[2]
    geo = slice_geometry(1080, 1920, cfg, H100_SMEM_OPTIN)
    assert isinstance(geo, SliceGeometry)
    assert 1 <= geo.band <= n and geo.bands == -(-n // geo.band)
    assert geo.tile * cfg.r <= 256 and geo.tiles == -(-nc // geo.tile)
    assert geo.smem == slice_smem_bytes(gz) <= H100_SMEM_OPTIN
    assert geo.bands * geo.tiles >= 4 * H100_SMS


def test_slice_geometry_rules():
    cfg = PAPER_DEFAULT.bg  # 90 stripes, 160 column cells, gz=4
    geo = lambda **kw: slice_geometry(1080, 1920, cfg, H100_SMEM_OPTIN, **kw)
    # one stripe per block, tiles of 21 cells (252 columns, one per thread):
    # 720 blocks per frame; the table is 2 planes x gz x 256 threads
    assert slice_smem_bytes(4) == 2 * 4 * 256 * 4 == 8192
    assert geo() == (1, 90, 21, 8, 8192)
    assert slice_geometry(1080, 1920, TABLE1_SWEEP[3].bg, H100_SMEM_OPTIN)[:4] == (1, 68, 16, 8)
    # explicit knobs are cut to the frame
    assert geo(band=500, tile=1000) == (90, 1, 160, 1, 8192)
    assert geo(band=7, tile=5)[:4] == (7, 13, 5, 32)
    # a grid so deep that one block's table does not fit raises naming the bytes
    deep = BGConfig(4, 4.0, 0.2)
    need = slice_smem_bytes(grid_shape(1080, 1920, deep)[2])
    assert need > H100_SMEM_OPTIN
    with pytest.raises(ValueError, match=f"{need} bytes"):
        slice_geometry(1080, 1920, deep, H100_SMEM_OPTIN)


# ------------------------------------------------------------- on the card
CARD = [((40, 55), SERVE_CONFIG), ((33, 47), BGConfig(4, 4.0, 60.0)),
        ((1080, 1918), PAPER_DEFAULT.bg), ((1080, 1920), BGConfig(16, 8.0, 70.0))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", CARD)
def test_staged_kernels_match_plain_on_card(cuda, shape, cfg):
    imgs = torch.from_numpy(noisy_np(3, *shape)).to(cuda)
    counts = (bg_create.launches, bg_blur.launches, bg_slice.launches)
    grid = bg_create(imgs, cfg)
    blurred = bg_blur(grid, cfg)
    gf = grid_normalize(blurred)
    out = bg_slice(gf, imgs, cfg)
    torch.cuda.synchronize()
    assert (bg_create.launches, bg_blur.launches, bg_slice.launches) == tuple(c + 1 for c in counts)
    assert torch.equal(grid, bg_create_plain(imgs, cfg))
    assert float(grid[..., 0].sum()) == 3 * shape[0] * shape[1]
    torch.testing.assert_close(blurred, bg_blur_plain(grid, cfg), atol=1e-2, rtol=1e-4)
    torch.testing.assert_close(out, bg_slice_plain(gf, imgs, cfg), atol=1e-3, rtol=0)
    # no atomics: launches agree, and a frame's rows do not depend on the batch
    assert torch.equal(bg_create(imgs, cfg), grid)
    assert torch.equal(bg_create(imgs[1], cfg), grid[1])
    assert torch.equal(bg_blur(grid[1].contiguous(), cfg), blurred[1])
    assert torch.equal(bg_slice(gf[1].contiguous(), imgs[1], cfg), out[1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", CARD)
def test_blur_kernel_equals_fused_blur_on_card(cuda, shape, cfg):
    """B5's grid equals the blurred grid of the fused template bit for bit
    (read from B2's carry at alpha 0 on a zero carry, which is 1*B + 0*0 = B
    exactly): every kernel compiles the GF taps as bg::tap3, rounded op by
    op, so the staged backend filters as the fused one does."""
    imgs = torch.from_numpy(noisy_np(3, *shape)).to(cuda)
    grid = bg_create(imgs, cfg)
    blurred = bg_blur(grid, cfg)
    fused = bg_fused(imgs, cfg, carry=torch.zeros_like(grid), alpha=torch.zeros(3, device=cuda))[1]
    plain = bg_blur_plain(grid, cfg)
    torch.cuda.synchronize()
    differ = {"b5_vs_fused": int((blurred != fused).sum()), "b5_vs_plain": int((blurred != plain).sum()),
              "fused_vs_plain": int((fused != plain).sum()), "values": blurred.numel()}
    assert differ["b5_vs_fused"] == 0, differ


# B4 at an odd frame size, a ragged full-HD width, r=2 and r=16 at full HD,
# and frames outside [0, 255] (their out-of-range bins dropped)
CREATE_CARD = [((1, 37, 53), BGConfig(4, 4.0, 60.0), 0.0, 255.0),
               ((2, 1080, 1917), PAPER_DEFAULT.bg, 0.0, 255.0),
               ((1, 1080, 1920), FIG12_SWEEPS["r"][0], 0.0, 255.0),
               ((2, 1080, 1920), BGConfig(16, 8.0, 70.0), 0.0, 255.0),
               ((2, 61, 83), SERVE_CONFIG, -60.0, 0.0),
               ((2, 61, 83), SERVE_CONFIG, 255.0, 330.0)]
# B4's knobs at their edges: single planes and cells, a band and a tile past
# the grid, tiles that do not divide gy, every z group
CREATE_GEOMETRIES = [dict(band=1, tile=1), dict(band=3, tile=7, zgroup=2), dict(band=500, tile=1000, zgroup=4),
                     dict(band=2, tile=5, zgroup=4), dict(band=1, tile=13, zgroup=1)]


def _frames(shape, lo, hi, seed=5):
    """Whole-valued frames uniform in [lo, hi], made with numpy."""
    return np.floor(np.random.default_rng(seed).uniform(lo, hi, shape)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg,lo,hi", CREATE_CARD)
def test_create_kernel_bitwise_plain_on_card(cuda, shape, cfg, lo, hi):
    """B4 equals its plain version bit for bit: on frames that start at an
    odd float of a batch, in every split of the knobs, for each frame of a
    batch alone, and across launches. Out-of-range bins are dropped."""
    b, h, w = shape
    frames = _frames(shape, lo, hi)
    imgs = torch.from_numpy(frames).to(cuda)
    before = bg_create.launches
    grid = bg_create(imgs, cfg)
    plain = bg_create_plain(imgs, cfg)
    torch.cuda.synchronize()
    assert bg_create.launches == before + 1
    assert torch.equal(grid, plain), float((grid - plain).abs().max())
    zbin = np.floor(frames * np.float32(1.0 / cfg.range_scale) + np.float32(0.5))
    assert float(grid[..., 0].sum()) == float(((zbin >= 0) & (zbin < cfg.gz)).sum())
    # a frame sliced from a batch at an odd float offset (4-byte aligned only)
    flat = torch.from_numpy(np.concatenate([[7.0], frames.reshape(-1)]).astype(np.float32)).to(cuda)
    odd = flat[1:].view(shape)
    assert odd.data_ptr() % 16 == 4 and torch.equal(bg_create(odd, cfg), grid)
    one = flat[1 + (b - 1) * h * w:].view(h, w)
    assert torch.equal(bg_create(one, cfg), grid[b - 1])
    assert torch.equal(bg_create(imgs, cfg), grid)
    cmod = importlib.import_module("repro_torch.kernels.bg_create")
    for knobs in CREATE_GEOMETRIES:
        got = torch.full_like(grid, float("nan"))
        geo = cmod._launch(imgs, got, cfg, **knobs)
        torch.cuda.synchronize()
        assert torch.equal(got, grid), (knobs, geo)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg,lo,hi", CREATE_CARD)
def test_create_then_blur_equals_fused_blur_on_card(cuda, shape, cfg, lo, hi):
    """B5(B4(x)) equals B1's blurred grid bit for bit (B2's carry at alpha 0
    on a zero carry) at B4's card shapes, as at ``CARD``'s."""
    imgs = torch.from_numpy(_frames(shape, lo, hi)).to(cuda)
    grid = bg_create(imgs, cfg)
    blurred = bg_blur(grid, cfg)
    fused = bg_fused(imgs, cfg, carry=torch.zeros_like(grid), alpha=torch.zeros(shape[0], device=cuda))[1]
    torch.cuda.synchronize()
    assert int((blurred != fused).sum()) == 0, (int((blurred != fused).sum()), blurred.numel())


# ragged grids: gx <= 2, runs longer than gx, y tiles that do not divide gy
BLUR_CARD = [(1, 1, 3, 2), (2, 2, 5, 3), (3, 7, 11, 4), (1, 92, 162, 4), (4, 13, 9, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BLUR_CARD)
def test_blur_kernel_ragged_grids_on_card(cuda, shape):
    """B5 against its plain version at GF's tolerance on ragged grids, and
    bit for bit across runs and y tiles (a plane's bits do not depend on the
    block that filters it)."""
    cfg = SERVE_CONFIG
    g = torch.from_numpy(np.random.default_rng(sum(shape)).uniform(0.0, 60.0, (*shape, 2)).astype(np.float32)).to(cuda)
    before = B5.launches
    ref = bg_blur(g, cfg)
    torch.cuda.synchronize()
    assert B5.launches == before + 1
    torch.testing.assert_close(ref, bg_blur_plain(g, cfg), atol=1e-2, rtol=1e-4)
    assert torch.equal(bg_blur(g[0], cfg), ref[0])
    b, gx, gy = shape[:3]
    bmod = importlib.import_module("repro_torch.kernels.bg_blur")
    for run, ytile in ((1, 1), (2, 3), (gx + 5, gy), (3, gy + 9)):
        got = torch.full_like(g, float("nan"))
        bmod._launch(g, got, cfg, run, ytile)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (run, ytile)


# B6's knobs at their edges: single stripes and cells, a band past the
# frame, tiles that do not divide the width, the whole width
SLICE_GEOMETRIES = [dict(band=1, tile=1), dict(band=3, tile=7), dict(band=500, tile=2), dict(band=2, tile=1000)]
SLICE_CARD = CARD + [((61, 83), BGConfig(7, 4.0, 50.0)), ((45, 55), SERVE_CONFIG), ((1080, 1920), PAPER_DEFAULT.bg)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", SLICE_CARD)
def test_slice_kernel_bitwise_plain_on_card(cuda, shape, cfg):
    """B6 equals its plain version bit for bit, at ragged widths and in
    every (band, tile) split."""
    imgs = torch.from_numpy(noisy_np(2, *shape)).to(cuda)
    gf = grid_normalize(bg_blur(bg_create(imgs, cfg), cfg))
    before = bg_slice.launches
    out = bg_slice(gf, imgs, cfg)
    plain = bg_slice_plain(gf, imgs, cfg)
    torch.cuda.synchronize()
    assert bg_slice.launches == before + 1
    assert torch.equal(out, plain), float((out - plain).abs().max())
    smod = importlib.import_module("repro_torch.kernels.bg_slice")
    for knobs in SLICE_GEOMETRIES:
        got = torch.full_like(imgs, float("nan"))
        geo = smod._launch(gf, imgs, got, cfg, **knobs)
        torch.cuda.synchronize()
        assert torch.equal(got, out), (knobs, geo)


@pytest.mark.gpu
def test_staged_backend_on_card_is_three_launches(cuda):
    cfg = SERVE_CONFIG
    frames = noisy_np(4, 45, 64)
    counts = (bg_create.launches, bg_blur.launches, bg_slice.launches, bg_fused.launches)
    out = BGPlan(cfg, backend="staged")(frames)
    torch.cuda.synchronize()
    after = (bg_create.launches, bg_blur.launches, bg_slice.launches, bg_fused.launches)
    assert after == (counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3])
    quantized_contract(out.cpu().numpy(), BGPlan(cfg, backend="fused")(frames).cpu().numpy())
