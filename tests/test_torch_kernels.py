"""The fused bilateral-grid kernel module of the port.

On the CPU, ``bg_fused`` runs its plain version; it is held to the JAX
package's fused Pallas kernel (interpret mode, default and streamed input)
and to ``ref_fused`` at the JAX package's tolerance (atol 5e-3,
tests/test_kernels.py), and to the per-frame bitwise contracts of
tests/test_batched_bg.py. The tests marked ``gpu`` run the CUDA kernels
(B1, B2 and the streamed B3) and skip without a card:

    pytest -m gpu tests/test_torch_kernels.py
"""
import importlib
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.bg_denoise import FIG12_SWEEPS, PAPER_DEFAULT, SERVE_CONFIG, TABLE1_SWEEP
from repro_torch.core import BGConfig, quantize_intensity, synthetic_image_np
from repro_torch.kernels import bg_fused, bg_fused_plain
from repro_torch.kernels.bg_fused import (
    H100_SMEM_OPTIN,
    launch_geometry,
    smem_bytes,
    stream_geometry,
    stream_smem_bytes,
)
from repro_torch.kernels.common import storage_dtype
from repro_torch.kernels.ref import ref_fused
from repro_torch.reliability import finite_rows

# the module (the package attribute of the same name is the wrapper)
K = importlib.import_module("repro_torch.kernels.bg_fused")

SHAPES = [(32, 32), (61, 83), (45, 200)]
PARAMS = [(2, 2.0, 30.0), (7, 4.0, 50.0), (12, 8.0, 70.0), (16, 8.0, 70.0)]
RAGGED = [((61, 83), 7), ((45, 200), 6), ((33, 47), 4)]  # h % r and w % r != 0
FULL_HD = [(f"table1-r{wl.bg.r}", wl.bg) for wl in TABLE1_SWEEP] + [("serve", SERVE_CONFIG)]


def noisy_np(*shape, seed=3):
    """(h, w) or (b, h, w) synthetic scenes + numpy noise, 8-bit quantized."""
    h, w = shape[-2:]
    b = shape[0] if len(shape) == 3 else 1
    clean = np.stack([synthetic_image_np(h, w, seed=seed + i) for i in range(b)])
    noise = np.random.default_rng(seed + 100).normal(0.0, 30.0, clean.shape)
    out = np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32)
    return out.reshape(shape)


@pytest.fixture
def jx():
    """The JAX package's fused kernel and oracle. The card's host has no JAX,
    so ``pytest -m gpu`` there must not import it with this module."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import BGConfig as JBGConfig
    from repro.kernels import bg_fused as j_bg_fused
    from repro.kernels.ref import ref_fused as j_ref_fused

    return SimpleNamespace(
        np=jnp.asarray, cfg=JBGConfig, bg_fused=j_bg_fused, ref_fused=j_ref_fused
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
def test_plain_matches_jax_fused_kernel_and_ref(jx, shape, params):
    img = noisy_np(*shape)
    port = bg_fused(torch.from_numpy(img), BGConfig(*params))
    assert port.shape == shape and port.dtype == torch.float32
    kernel = np.asarray(jx.bg_fused(jx.np(img), jx.cfg(*params), interpret=True))
    ref = np.asarray(jx.ref_fused(jx.np(img), jx.cfg(*params)))
    np.testing.assert_allclose(port.numpy(), kernel, atol=5e-3)
    np.testing.assert_allclose(port.numpy(), ref, atol=5e-3)
    np.testing.assert_allclose(
        port.numpy(), ref_fused(torch.from_numpy(img), BGConfig(*params)).numpy(), atol=5e-3
    )


def test_pow2_weight_mode(jx):
    img = noisy_np(48, 64)
    port = bg_fused(torch.from_numpy(img), BGConfig(8, 8.0, 70.0, weight_mode="pow2"))
    ref = jx.ref_fused(jx.np(img), jx.cfg(8, 8.0, 70.0, weight_mode="pow2"))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=5e-3)


@pytest.mark.parametrize("shape,r", RAGGED)
def test_ragged_batch_matches_ref_per_frame(jx, shape, r):
    imgs = noisy_np(3, *shape)
    out = bg_fused(torch.from_numpy(imgs), BGConfig(r, 4.0, 60.0))
    assert out.shape == (3,) + shape
    for i in range(3):
        ref = np.asarray(jx.ref_fused(jx.np(imgs[i]), jx.cfg(r, 4.0, 60.0)))
        np.testing.assert_allclose(out[i].numpy(), ref, atol=5e-3)


@pytest.mark.parametrize("shape,r", RAGGED)
def test_b1_bitwise_single_frame(shape, r):
    img = torch.from_numpy(noisy_np(*shape))
    single = bg_fused(img, BGConfig(r, 4.0, 60.0))
    batched = bg_fused(img[None], BGConfig(r, 4.0, 60.0))
    assert batched.shape == (1,) + shape
    assert torch.equal(batched[0], single)


@pytest.mark.parametrize("batch_tile", [1, 2, 4, 7])
def test_output_independent_of_batch_tile(batch_tile):
    cfg = BGConfig(6, 4.0, 60.0)
    imgs = torch.from_numpy(noisy_np(5, 40, 55))
    base = bg_fused(imgs, cfg)
    assert torch.equal(bg_fused(imgs, cfg, batch_tile=batch_tile), base)
    assert torch.equal(bg_fused_plain(imgs, cfg, batch_tile=batch_tile), base)
    for i in range(5):
        assert torch.equal(bg_fused(imgs[i].clone(), cfg), base[i])


def same_or_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit where not NaN, and NaN at the same places."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a.masked_fill(nan, 0.0),
                                                       b.masked_fill(b.isnan(), 0.0))


def _below(v: float) -> float:
    return float(np.nextafter(np.float32(v), np.float32(-np.inf)))


def _above(v: float) -> float:
    return float(np.nextafter(np.float32(v), np.float32(np.inf)))


# (v, quantize_intensity(v) at intensity_max 255): torch.clamp(torch.floor(v
# + 0.5), 0, 255) in fp32. Ties k + 0.5 round up and an ulp below one rounds
# down, except under 1, where v + 0.5 itself rounds up to the tie's integer
# (0.49999997 + 0.5 is 1.0 in fp32); the clamp keeps NaN and sends -inf
# and +inf to the range's ends. The fused kernels' store (bg::quantize) must
# give these bits.
QUANT_EDGES = [(2.5, 3.0), (_below(2.5), 2.0), (_above(2.5), 3.0), (1.5, 2.0), (3.5, 4.0),
               (_below(3.5), 3.0), (2.0, 2.0), (_below(2.0), 2.0), (0.5, 1.0), (_below(0.5), 1.0),
               (-0.5, 0.0), (_below(-0.5), 0.0), (254.5, 255.0), (_below(254.5), 254.0),
               (255.5, 255.0), (_below(255.5), 255.0), (300.0, 255.0), (-7.25, 0.0),
               (float("inf"), 255.0), (float("-inf"), 0.0), (float("nan"), float("nan"))]


def test_quantize_edge_values_follow_torch_clamp():
    v = torch.tensor([e[0] for e in QUANT_EDGES], dtype=torch.float32)
    want = torch.tensor([e[1] for e in QUANT_EDGES], dtype=torch.float32)
    cfg = BGConfig(6, 4.0, 60.0)
    got = quantize_intensity(v, cfg)
    assert same_or_nan(got, want)
    assert same_or_nan(got, torch.clamp(torch.floor(v + 0.5), 0.0, 255.0))
    # a NaN row still fails the packer's finite guard, nothing else does
    rows = got[None].repeat(3, 1)
    rows[1:].masked_fill_(rows[1:].isnan(), 0.0)
    assert finite_rows(rows).tolist() == [False, True, True]


@pytest.mark.parametrize("temporal", [False, True], ids=["frame", "temporal"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plain_quantize_is_quantize_intensity_of_the_output(precision, temporal):
    """``bg_fused(..., quantize=True)`` on the CPU (the plain version) equals
    ``quantize_intensity`` of the unquantized output, upcast, bit for bit:
    round to the storage type, then quantize. The output stays in the
    storage type, the carry is not quantized, and a frame with a NaN pixel
    keeps a NaN row that the finite guard flags."""
    cfg = BGConfig(6, 4.0, 60.0)
    sdt = storage_dtype(precision)
    x = torch.from_numpy(noisy_np(3, 40, 55))
    x[0, 20, 30] = float("nan")
    x = x.to(sdt)
    kw = dict(precision=precision)
    if temporal:
        _, carry, alpha = temporal_inputs(3, 40, 55, cfg, "cpu")
        kw.update(carry=carry.to(sdt), alpha=alpha)
    raw = bg_fused(x, cfg, **kw)
    got = bg_fused(x, cfg, batch_tile=2, quantize=True, **kw)
    plain = bg_fused_plain(x, cfg, quantize=True, **kw)
    if temporal:
        (raw, raw_carry), (got, carry_q), (plain, plain_carry) = raw, got, plain
        assert same_or_nan(carry_q.float(), raw_carry.float())
        assert same_or_nan(plain_carry.float(), raw_carry.float())
    assert got.dtype == plain.dtype == sdt
    want = quantize_intensity(raw.float(), cfg)
    assert same_or_nan(got.float(), want) and same_or_nan(plain.float(), want)
    if not temporal:  # a frame alone equals its row of the batch
        assert torch.equal(bg_fused(x[1], cfg, quantize=True, precision=precision), got[1])
    assert finite_rows(got).tolist() == [False, True, True]


STREAMED = [((40, 55), 6, 1), ((40, 55), 6, 3), ((61, 83), 7, 3), ((33, 47), 4, 1), ((60, 96), 5, 3)]


@pytest.mark.parametrize("shape,r,b", STREAMED)
def test_streamed_matches_jax_streamed_kernel(jx, shape, r, b):
    """``stream_input=True`` on the CPU (the plain version) against the JAX
    package's streamed Pallas kernel, ragged shapes and b in {1, 3}."""
    imgs = noisy_np(b, *shape, seed=r)
    cfg, jcfg = BGConfig(r, 4.0, 60.0), jx.cfg(r, 4.0, 60.0)
    port = bg_fused(torch.from_numpy(imgs), cfg, stream_input=True)
    kernel = np.asarray(jx.bg_fused(jx.np(imgs), jcfg, interpret=True, stream_input=True))
    assert port.shape == (b,) + shape
    np.testing.assert_allclose(port.numpy(), kernel, atol=5e-3)
    single = bg_fused(torch.from_numpy(imgs[0]), cfg, stream_input=True)
    assert torch.equal(single, port[0]) and torch.equal(port, bg_fused(torch.from_numpy(imgs), cfg))


def test_streamed_rejects_a_carry_as_jax_does(jx):
    img = noisy_np(2, 24, 30)
    cfg = BGConfig(6, 4.0, 60.0)
    carry = np.zeros((2, *K.grid_shape(24, 30, cfg), 2), np.float32)
    alpha = np.zeros(2, np.float32)
    msg = "stream_input does not compose with a temporal carry"
    with pytest.raises(ValueError, match=msg):
        jx.bg_fused(jx.np(img), jx.cfg(6, 4.0, 60.0), interpret=True, stream_input=True,
                    carry=jx.np(carry), alpha=jx.np(alpha))
    with pytest.raises(ValueError, match=msg):
        bg_fused(torch.from_numpy(img), cfg, carry=torch.from_numpy(carry),
                 alpha=torch.from_numpy(alpha), stream_input=True)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    cfg = BGConfig(6, 4.0, 60.0)
    img = torch.zeros(2, 12, 12)
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="batch_tile"):
            bg_fused(img, cfg, batch_tile=bad)
    with pytest.raises(TypeError, match="float32"):
        bg_fused(img.double(), cfg)
    with pytest.raises(TypeError):
        bg_fused(img.numpy(), cfg)
    with pytest.raises(ValueError, match="frames"):
        bg_fused(torch.zeros(1, 2, 12, 12), cfg)
    with pytest.raises(ValueError, match="paper"):
        bg_fused(img, BGConfig(6, 4.0, 60.0, normalize_mode="classic"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bg_fused(img.to("meta"), cfg)


# ------------------------------------------------- CPU: launch geometry
@pytest.mark.parametrize("name,cfg", FULL_HD)
def test_full_hd_configs_fit_shared_memory(name, cfg):
    """Every full-HD config gets a block that fits, bands and column tiles
    that cover the frame, and at least one block per SM at b = 1, 4, 8."""
    _, gy, gz = K.grid_shape(1080, 1920, cfg)
    n, nc = -(-1080 // cfg.r), -(-1920 // cfg.r)
    for b in (1, 4, 8):
        geo = launch_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN)
        assert 1 <= geo.band <= K._MAX_BAND and geo.bands == -(-n // geo.band)
        assert 1 <= geo.tile <= nc and geo.tiles == -(-nc // geo.tile)
        assert 1 <= geo.rows <= cfg.r
        assert geo.smem == smem_bytes(geo.band, geo.tile, geo.rows, cfg.r, gz) <= H100_SMEM_OPTIN
        assert b * geo.bands * geo.tiles >= 132


def test_working_set_beyond_shared_memory_raises_with_bytes():
    """r=2 at full HD no longer needs the whole width in one block: the
    column tile is cut until it fits. Below one stripe x one cell x one row
    nothing fits, and the error names the bytes."""
    r2 = FIG12_SWEEPS["r"][0]
    assert r2.r == 2
    geo = launch_geometry(1, 1080, 1920, r2, 132, H100_SMEM_OPTIN)
    assert geo.smem <= H100_SMEM_OPTIN and geo.tiles > 1
    assert smem_bytes(1, 960, 1, 2, r2.gz) > H100_SMEM_OPTIN  # the whole width does not fit
    need = smem_bytes(1, 1, 1, 2, r2.gz)
    with pytest.raises(ValueError, match=f"{need} bytes"):
        launch_geometry(1, 1080, 1920, r2, 132, need - 1)


def test_band_rules():
    cfg = PAPER_DEFAULT.bg  # 90 stripes, 160 column cells, gz=4
    geo = lambda b, **kw: launch_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN, **kw)
    # tiles of 40 cells (480 px); bands grow with the batch, up to 6; GC
    # steps as deep as keeps every block resident
    assert geo(1)[:5] == (1, 90, 40, 4, 4)
    assert geo(4)[:5] == (4, 23, 40, 4, 2)
    assert geo(8)[:5] == (6, 15, 40, 4, 1)
    # explicit knobs are cut to the frame and to shared memory, rows first
    assert geo(1, band=500, tile=1000)[:5] == (7, 13, 160, 1, 1)
    assert launch_geometry(1, 30, 1920, cfg, 132, H100_SMEM_OPTIN, band=500)[0] == 3
    assert geo(8, rows=99).rows == 5


@pytest.mark.parametrize("name,cfg", FULL_HD)
def test_full_hd_temporal_working_set_fits(name, cfg):
    """The temporal launch sizes every block for the last band's working
    set: one more raw plane, for the drain."""
    _, gy, gz = K.grid_shape(1080, 1920, cfg)

    def layout(band, tile, rows, t):  # raw planes, normalized planes, GC slots or TI table
        nr = tile + 3
        slots = max(2 * (band + 3) * rows * cfg.r * (nr | 1), 2 * gz * K.THREADS)
        return 4 * ((band + 3 + t) * 2 * gz * nr + (band + 1) * gz * (tile + 1) + slots)

    for band, tile, rows in ((1, 1, 1), (2, 40, 4), (4, 160, 1)):
        for t in (False, True):
            assert smem_bytes(band, tile, rows, cfg.r, gz, temporal=t) == layout(band, tile, rows, int(t))
        assert smem_bytes(band, tile, rows, cfg.r, gz, temporal=True) > smem_bytes(band, tile, rows, cfg.r, gz)
    for b in (1, 4, 8):
        geo = launch_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN, temporal=True)
        assert geo.smem == smem_bytes(geo.band, geo.tile, geo.rows, cfg.r, gz, temporal=True)
        assert geo.smem <= H100_SMEM_OPTIN
    # PAPER_DEFAULT and the serve grid at b=8: bands of 4, 480-pixel tiles
    assert smem_bytes(4, 40, 2, 12, 4, temporal=True) == 72080
    assert smem_bytes(4, 80, 2, 6, 4, temporal=True) == 83504


@pytest.mark.parametrize("name,cfg", FULL_HD)
def test_full_hd_configs_fit_the_streamed_kernel(name, cfg):
    """Every full-HD config gets a streamed block that fits, bands and column
    tiles that cover the frame, at least one block per SM at b = 1, 4, 8,
    and no more blocks than the card holds at once."""
    _, gy, gz = K.grid_shape(1080, 1920, cfg)
    n, nc = -(-1080 // cfg.r), -(-1920 // cfg.r)
    for b in (1, 4, 8):
        geo = stream_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN)
        assert isinstance(geo, K.StreamGeometry)
        assert 1 <= geo.band <= n and geo.bands == -(-n // geo.band)
        assert 1 <= geo.tile <= nc and geo.tiles == -(-nc // geo.tile)
        assert 1 <= geo.chunk <= cfg.r and geo.zgroup in (1, 2, 4)
        assert geo.ring_rows == -(-(2 * cfg.r + K.gc_row_split(cfg.r) + geo.chunk) // 4) * 4
        assert geo.smem == stream_smem_bytes(geo.tile, geo.chunk, cfg.r, gz) <= H100_SMEM_OPTIN
        resident = H100_SMEM_OPTIN // (geo.smem + K._SMEM_PER_BLOCK)
        assert 132 <= b * geo.bands * geo.tiles <= resident * 132


def test_streamed_geometry_rules():
    cfg = PAPER_DEFAULT.bg  # 90 stripes, 160 column cells, gz=4
    geo = lambda b, **kw: stream_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN, **kw)
    # B1's 40-cell tiles, whole-stripe chunks (12 rows still hold 2 blocks
    # per SM), GC tasks of 2 z bins (43 cells x 2 groups); the band is the
    # shortest that keeps every block resident
    assert geo(8) == (12, 8, 40, 4, 12, 2, 44, 114672)
    assert geo(4)[:4] == (6, 15, 40, 4)
    # one frame (360 single-stripe blocks, under two waves of 2 per SM):
    # 20-cell tiles, 3 blocks per SM, one-bin GC tasks (23 cells x 4 bins)
    assert geo(1) == (2, 45, 20, 8, 12, 1, 44, 65712)
    # the layout: 4 raw planes and the x-mixed plane (2 channels x gz x 43
    # cells), 2 normalized planes x gz x 41, the TI table 2 x gz x 256 and
    # r x fractions, to a multiple of 4 floats; 2r + split + chunk = 42 ring
    # rows, rounded up to 44, of 43 x 12 columns plus up to 3 of alignment,
    # rounded up to 520, plus up to 3 for the frame width; 12 rows of z bin
    # bytes, 3 words per cell
    assert K.ring_rows(12, 12) == 44 and K.ring_rows(12, 1) == 32
    assert stream_smem_bytes(40, 12, 12, 4) == 4 * (4108 + 44 * 523 + 12 * 43 * 3) == 114672
    # explicit knobs are cut to the frame and a chunk to r rows ...
    assert geo(8, band=500, tile=30, chunk=99, zgroup=4)[:7] == (90, 1, 30, 6, 12, 4, 44)
    # ... and to shared memory: a 100-cell tile fits with 6-row chunks; the
    # whole width (160 cells) does not fit even with one-row chunks, so the
    # tile is halved
    assert geo(8, tile=100, chunk=99)[2:5] == (100, 2, 6)
    assert geo(8, tile=1000)[2:4] == (80, 2)
    with pytest.raises(ValueError, match="zgroup"):
        geo(8, zgroup=3)
    # a limit that holds a 20-cell tile with one-row chunks and no more
    small = stream_geometry(8, 1080, 1920, cfg, 132, stream_smem_bytes(20, 1, 12, 4))
    assert (small.tile, small.chunk, small.smem) == (20, 1, 49092)
    # FIG12 r=2 at full HD fits, with its own sigmas and with PAPER_DEFAULT's
    for r2 in (FIG12_SWEEPS["r"][0], BGConfig(2, 8.0, 70.0)):
        g2 = stream_geometry(1, 1080, 1920, r2, 132, H100_SMEM_OPTIN)
        assert g2.smem <= H100_SMEM_OPTIN and g2.tiles * g2.tile >= 960
    # a grid so deep that one column cell with one-row chunks does not fit
    # (gz = 257: the TI table alone is 526,336 B) raises naming the bytes
    deep = BGConfig(4, 4.0, 1.0)
    need = stream_smem_bytes(1, 1, 4, deep.gz)
    assert need > H100_SMEM_OPTIN
    with pytest.raises(ValueError, match=f"{need} bytes"):
        stream_geometry(1, 1080, 1920, deep, 132, H100_SMEM_OPTIN)


# ------------------------------------------------------------- on the card
TEMPORAL_CARD = [((36, 48), SERVE_CONFIG), ((45, 55), SERVE_CONFIG), ((33, 47), BGConfig(4, 4.0, 60.0)),
                 ((1080, 1920), PAPER_DEFAULT.bg)]


def temporal_inputs(n, h, w, cfg, device, seed=5):
    frames = torch.from_numpy(noisy_np(n, h, w, seed=seed)).to(device)
    rng = np.random.default_rng(seed)
    carry = torch.from_numpy(
        rng.uniform(0.0, 4.0, (n, *K.grid_shape(h, w, cfg), 2)).astype(np.float32)
    ).to(device)
    alpha = torch.tensor([0.0, 0.4, 0.6, 0.8][:n], device=device)
    return frames, carry, alpha


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", TEMPORAL_CARD)
def test_temporal_kernel_matches_plain_on_card(cuda, shape, cfg):
    frames, carry, alpha = temporal_inputs(4, *shape, cfg, cuda)
    b1, b2 = bg_fused.launches, bg_fused.temporal_launches
    out, new_carry = bg_fused(frames, cfg, carry=carry, alpha=alpha)
    torch.cuda.synchronize()
    assert bg_fused.temporal_launches == b2 + 1 and bg_fused.launches == b1
    assert new_carry.data_ptr() != carry.data_ptr()
    p_out, p_carry = bg_fused_plain(frames, cfg, carry=carry, alpha=alpha)
    assert float((out - p_out).abs().max()) <= 5e-3
    torch.testing.assert_close(new_carry, p_carry, atol=2e-2, rtol=1e-3)
    gx = new_carry.shape[1]
    if shape[0] % cfg.r == 0:  # the drain plane: TI never reads it, the EMA must
        assert float(p_carry[:, gx - 1].abs().max()) > 0.0
    # chained: the second step on the carry the first returned
    out2, carry2 = bg_fused(frames.flip(0).contiguous(), cfg, carry=new_carry, alpha=alpha)
    p_out2, p_carry2 = bg_fused_plain(frames.flip(0).contiguous(), cfg, carry=p_carry, alpha=alpha)
    assert float((out2 - p_out2).abs().max()) <= 5e-3
    torch.testing.assert_close(carry2, p_carry2, atol=2e-2, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", TEMPORAL_CARD)
def test_temporal_alpha0_rows_bitwise_b1_on_card(cuda, shape, cfg):
    frames, carry, alpha = temporal_inputs(4, *shape, cfg, cuda)
    ref = bg_fused(frames, cfg)
    out, new = bg_fused(frames, cfg, carry=carry, alpha=alpha)
    assert torch.equal(out[0], ref[0])  # alpha[0] == 0
    out0, _ = bg_fused(frames, cfg, carry=carry, alpha=torch.zeros_like(alpha))
    assert torch.equal(out0, ref)
    # b=1 equals its row of the batch, image and carry; two launches agree
    o1, c1 = bg_fused(frames[2:3].contiguous(), cfg, carry=carry[2:3].contiguous(), alpha=alpha[2:3].contiguous())
    assert torch.equal(o1[0], out[2]) and torch.equal(c1[0], new[2])
    again = bg_fused(frames, cfg, carry=carry, alpha=alpha)
    assert torch.equal(again[0], out) and torch.equal(again[1], new)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", TEMPORAL_CARD)
def test_temporal_carry_planes_have_one_owner(cuda, shape, cfg):
    """Every carry plane is written (none left at its NaN fill) and its bits
    do not depend on how many stripes and column cells a block owns."""
    frames, carry, alpha = temporal_inputs(3, *shape, cfg, cuda)
    ref_out, ref_carry = None, None
    for band, tile in ((1, None), (2, 1), (3, 5), (500, None)):
        out = torch.empty_like(frames)
        new = torch.full_like(carry, float("nan"))
        K._launch(frames, out, cfg, band, carry=carry, carry_out=new, alpha=alpha[:3].contiguous(), tile=tile)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(new).all()) and bool(torch.isfinite(out).all())
        if ref_out is None:
            ref_out, ref_carry = out, new
        assert torch.equal(out, ref_out) and torch.equal(new, ref_carry)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + [(1080, 1920)])
@pytest.mark.parametrize("params", PARAMS[1:])
def test_kernel_matches_plain_on_card(cuda, shape, params):
    cfg = BGConfig(*params)
    imgs = torch.from_numpy(noisy_np(3, *shape)).to(cuda)
    before = bg_fused.launches
    out = bg_fused(imgs, cfg)
    torch.cuda.synchronize()
    assert bg_fused.launches == before + 1 and out.is_cuda
    plain = bg_fused_plain(imgs, cfg)
    assert float((out - plain).abs().max()) <= 5e-3
    diff = (quantize_intensity(out, cfg) - quantize_intensity(plain, cfg)).abs()
    assert float((diff == 0).float().mean()) >= 0.995 and float(diff.max()) <= 1.0
    assert torch.equal(bg_fused(imgs, cfg), out)  # no atomics: launches agree
    assert torch.equal(bg_fused(imgs[1:2].contiguous(), cfg)[0], out[1])
    assert torch.equal(bg_fused(imgs, cfg, batch_tile=2), out)


# B3's knobs at their edges: single stripes, cells and rows, one-bin GC
# tasks, a band past the frame, tiles that do not divide the width, chunks
# past r, the whole width
STREAM_GEOMETRIES = [dict(band=1, tile=1, chunk=1, zgroup=1), dict(band=3, tile=7, chunk=5, zgroup=2),
                     dict(band=500, tile=2, chunk=99, zgroup=4), dict(band=2, tile=1000, chunk=2, zgroup=1),
                     dict(band=4, tile=3, chunk=3, zgroup=4)]


STREAMED_CARD = [((40, 55), SERVE_CONFIG), ((45, 55), SERVE_CONFIG), ((33, 47), BGConfig(4, 4.0, 60.0)),
                 ((61, 83), BGConfig(7, 4.0, 50.0)), ((1080, 1918), PAPER_DEFAULT.bg),
                 ((1080, 1920), TABLE1_SWEEP[3].bg)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", STREAMED_CARD)
def test_streamed_kernel_bitwise_b1_on_card(cuda, shape, cfg):
    imgs = torch.from_numpy(noisy_np(3, *shape)).to(cuda)
    ref = bg_fused(imgs, cfg)
    b1, b3 = bg_fused.launches, bg_fused.streamed_launches
    out = bg_fused(imgs, cfg, stream_input=True)
    torch.cuda.synchronize()
    assert bg_fused.streamed_launches == b3 + 1 and bg_fused.launches == b1
    assert torch.equal(out, ref)
    assert torch.equal(bg_fused(imgs[1], cfg, stream_input=True), ref[1])
    # frames 1.. start h*w floats in: an unaligned source when h*w is odd
    assert torch.equal(bg_fused(imgs[1:], cfg, stream_input=True), ref[1:])
    assert torch.equal(bg_fused(imgs, cfg, batch_tile=2, stream_input=True), ref)
    n = -(-shape[0] // cfg.r)
    for knobs in STREAM_GEOMETRIES + [dict(band=n)]:
        got = torch.full_like(imgs, float("nan"))
        K._stream_launch(imgs, got, cfg, **knobs)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), knobs


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", [((61, 83), BGConfig(7, 4.0, 50.0)), ((45, 55), SERVE_CONFIG),
                                       ((1080, 1918), PAPER_DEFAULT.bg)])
def test_streamed_geometries_bitwise_on_card(cuda, shape, cfg):
    """B3's output does not depend on its split: every (band, tile, chunk,
    z group) gives B1's bits."""
    imgs = torch.from_numpy(noisy_np(2, *shape)).to(cuda)
    ref = bg_fused(imgs, cfg)
    for knobs in STREAM_GEOMETRIES:
        got = torch.full_like(imgs, float("nan"))
        geo = K._stream_launch(imgs, got, cfg, **knobs)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (knobs, geo)


def card_frames(b, h, w, device, seed=0):
    """b full-size frames made on the card: frame 0 a noisy synthetic scene,
    the rest uniform in [0, 256), floored."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.floor(torch.rand((b, h, w), generator=gen, device=device) * 256.0)
    x[0] = torch.from_numpy(noisy_np(h, w, seed=seed)).to(device)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", [((1080, 1920), c) for _, c in FULL_HD] + [
    ((1080, 1920), FIG12_SWEEPS["r"][0]), ((1080, 1920), BGConfig(2, 8.0, 70.0)),
    ((1080, 1918), PAPER_DEFAULT.bg)])
def test_streamed_kernel_full_hd_bitwise_b1_on_card(cuda, shape, cfg):
    """B3 equals B1 bit for bit at every full-HD config (r=2 included, with
    FIG12's sigmas and with PAPER_DEFAULT's), at b = 1 and 8."""
    x = card_frames(8, *shape, cuda)
    ref = bg_fused(x, cfg)
    assert torch.equal(bg_fused(x, cfg, stream_input=True), ref)
    assert torch.equal(bg_fused(x[3:4].contiguous(), cfg, stream_input=True), ref[3:4])


@pytest.mark.gpu
def test_streamed_kernel_raises_where_nothing_fits(cuda):
    """A grid so deep (gz = 257) that one column cell with one-row chunks
    does not fit in shared memory raises naming the bytes."""
    with pytest.raises(ValueError, match="bytes"):
        bg_fused(torch.zeros(1, 1080, 1920, device=cuda), BGConfig(4, 4.0, 1.0), stream_input=True)


@pytest.mark.gpu
def test_cuda_tensor_never_reaches_plain(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(K, "bg_fused_plain", boom)
    monkeypatch.setattr(K, "_plain_frames", boom)
    for stream_input in (False, True):
        out = K.bg_fused(torch.from_numpy(noisy_np(2, 45, 200)).to(cuda), SERVE_CONFIG,
                         stream_input=stream_input)
        torch.cuda.synchronize()
        assert out.is_cuda and out.shape == (2, 45, 200)


@pytest.mark.gpu
def test_kernel_rejects_non_contiguous_and_oversized(cuda):
    """What the kernel does not take raises: strided frames, and more
    frames than one launch holds. (r=2 at full HD, which raised before the
    column tiles, now runs: test_kernel_r2_full_hd_matches_plain_on_card.)"""
    imgs = torch.zeros(2, 64, 96, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bg_fused(imgs.transpose(1, 2), SERVE_CONFIG)
    with pytest.raises(ValueError, match="exceed one launch"):
        bg_fused(torch.zeros(65536, 1, 2, device=cuda), SERVE_CONFIG)


@pytest.mark.gpu
def test_kernel_r2_full_hd_matches_plain_on_card(cuda):
    """FIG12 r=2 at 1080x1920 (461,760 B of shared memory for the whole
    width) runs in column tiles and matches its plain version; so does B3,
    in its own column tiles, equal to B1 bit for bit."""
    cfg = FIG12_SWEEPS["r"][0]
    img = torch.from_numpy(noisy_np(1, 1080, 1920)).to(cuda)
    out = bg_fused(img, cfg)
    torch.cuda.synchronize()
    assert float((out - bg_fused_plain(img, cfg)).abs().max()) <= 5e-3
    assert torch.equal(bg_fused(img, cfg, stream_input=True), out)


# B1's split knobs at their edges: single stripes and cells, a band past
# the frame, tiles that do not divide the width, one-row and cut GC steps
GEOMETRIES = [dict(band=1, tile=1, rows=1), dict(band=3, tile=7, rows=5), dict(band=500, tile=2, rows=2),
              dict(band=2, tile=1000, rows=99)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cfg", [((61, 83), BGConfig(7, 4.0, 50.0)), ((45, 55), SERVE_CONFIG),
                                       ((1080, 1918), PAPER_DEFAULT.bg)])
def test_kernel_geometries_bitwise_on_card(cuda, shape, cfg):
    """B1's output does not depend on its split: every geometry gives the
    default launch's bits, within 5e-3 of plain, and B3 equals it; so do
    the temporal launch's image and carry."""
    imgs = torch.from_numpy(noisy_np(2, *shape)).to(cuda)
    ref = bg_fused(imgs, cfg)
    assert float((ref - bg_fused_plain(imgs, cfg)).abs().max()) <= 5e-3
    assert torch.equal(bg_fused(imgs, cfg, stream_input=True), ref)
    frames, carry, alpha = temporal_inputs(2, *shape, cfg, cuda)
    t_ref = bg_fused(frames, cfg, carry=carry, alpha=alpha)
    for knobs in GEOMETRIES:
        got = torch.full_like(imgs, float("nan"))
        K._launch(imgs, got, cfg, **knobs)
        out = torch.full_like(frames, float("nan"))
        new = torch.full_like(carry, float("nan"))
        K._launch(frames, out, cfg, carry=carry, carry_out=new, alpha=alpha, **knobs)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), knobs
        assert torch.equal(out, t_ref[0]) and torch.equal(new, t_ref[1]), knobs


def test_build_without_nvcc_raises_and_names_it(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all(["bg_fused"])
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").glob("*.so"))
    # the cache name follows the source and the flags
    name = _build._target("bg_fused").name
    assert name.startswith("bg_fused-") and name.endswith(".so")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX",))
    assert _build._target("bg_fused").name != name


def test_build_target_follows_included_headers(monkeypatch, tmp_path):
    """A source's cache name covers every csrc header it includes, directly
    or through another header, so an edited header is never a stale build."""
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    kernels = ("bg_fused", "bg_fused_streamed", "bg_create", "bg_blur", "bg_slice")
    staging = ("bg_fused", "bg_fused_streamed", "bg_create", "bg_blur")  # stage through cp.async
    for name in kernels:
        copy = ["bg_copy.cuh"] if name in staging else []
        assert _build._sources(name) == [f"{name}.cu", "bg_common.cuh"] + copy
    before = {n: _build._target(n).name for n in kernels}
    header = csrc / "bg_common.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    edited = {n: _build._target(n).name for n in kernels}
    assert all(edited[n] != before[n] for n in kernels)
    copy = csrc / "bg_copy.cuh"
    copy.write_text(copy.read_text() + "\n// an edit\n")
    assert {n for n in kernels if _build._target(n).name != edited[n]} == set(staging)
    edited = {n: _build._target(n).name for n in kernels}
    # a header included by the header counts too
    (csrc / "bg_extra.cuh").write_text("#pragma once\n")
    header.write_text('#include "bg_extra.cuh"\n' + header.read_text())
    assert _build._sources("bg_blur") == ["bg_blur.cu", "bg_common.cuh", "bg_copy.cuh", "bg_extra.cuh"]
    nested = _build._target("bg_blur").name
    (csrc / "bg_extra.cuh").write_text("#pragma once\n// changed\n")
    assert _build._target("bg_blur").name not in (nested, edited["bg_blur"])


# ------------------------------------------------------------ bf16 storage
# The geometry rules' fp32 results from before they took the element size,
# on an H100's limits: (config, frames, temporal or "s" for B3, geometry)
FP32_GEOMETRIES = [
    ('paper', 1, False, (1, 90, 40, 4, 4, 72864)),
    ('paper', 1, True, (1, 90, 40, 4, 4, 74240)),
    ('paper', 1, 's', (2, 45, 20, 8, 12, 1, 44, 65712)),
    ('paper', 4, False, (4, 23, 40, 4, 2, 70704)),
    ('paper', 4, True, (4, 23, 40, 4, 2, 72080)),
    ('paper', 4, 's', (6, 15, 40, 4, 12, 2, 44, 114672)),
    ('paper', 8, False, (6, 15, 40, 4, 1, 54128)),
    ('paper', 8, True, (6, 15, 40, 4, 1, 55504)),
    ('paper', 8, 's', (12, 8, 40, 4, 12, 2, 44, 114672)),
    ('serve', 1, False, (2, 90, 80, 4, 2, 57008)),
    ('serve', 1, True, (2, 90, 80, 4, 2, 59664)),
    ('serve', 1, 's', (3, 60, 80, 4, 6, 4, 24, 78744)),
    ('serve', 4, False, (6, 30, 80, 4, 1, 68832)),
    ('serve', 4, True, (6, 30, 80, 4, 1, 71488)),
    ('serve', 4, 's', (12, 15, 80, 4, 6, 4, 24, 78744)),
    ('serve', 8, False, (6, 30, 80, 4, 1, 68832)),
    ('serve', 8, True, (6, 30, 80, 4, 1, 71488)),
    ('serve', 8, 's', (23, 8, 80, 4, 6, 4, 24, 78744)),
    ('r4', 1, False, (3, 90, 120, 4, 1, 94176)),
    ('r4', 1, True, (3, 90, 120, 4, 1, 103032)),
    ('r4', 1, 's', (5, 54, 120, 4, 4, 4, 16, 105344)),
    ('r4', 4, False, (6, 45, 120, 4, 1, 145620)),
    ('r4', 4, True, (6, 45, 120, 4, 1, 154476)),
    ('r4', 4, 's', (17, 16, 120, 4, 4, 4, 16, 105344)),
    ('r4', 8, False, (6, 45, 120, 4, 1, 145620)),
    ('r4', 8, True, (6, 45, 120, 4, 1, 154476)),
    ('r4', 8, 's', (34, 8, 120, 4, 4, 4, 16, 105344)),
    ('r2', 1, False, (3, 180, 240, 4, 1, 210816)),
    ('r2', 1, True, (2, 270, 240, 4, 1, 199248)),
    ('r2', 1, 's', (17, 32, 240, 4, 2, 4, 8, 182152)),
    ('r2', 4, False, (3, 180, 240, 4, 1, 210816)),
    ('r2', 4, True, (2, 270, 240, 4, 1, 199248)),
    ('r2', 4, 's', (68, 8, 240, 4, 2, 4, 8, 182152)),
    ('r2', 8, False, (3, 180, 240, 4, 1, 210816)),
    ('r2', 8, True, (2, 270, 240, 4, 1, 199248)),
    ('r2', 8, 's', (135, 4, 240, 4, 2, 4, 8, 182152)),
]
GEOMETRY_CFGS = {"paper": PAPER_DEFAULT.bg, "serve": SERVE_CONFIG, "r4": TABLE1_SWEEP[0].bg,
                 "r2": BGConfig(2, 4.0, 50.0)}


def test_fp32_geometry_rules_unchanged_by_the_element_size():
    """The split rules with the default (fp32) element size return what they
    did before bf16 was ported, and ``esize=4`` is that default."""
    for name, b, kind, want in FP32_GEOMETRIES:
        cfg = GEOMETRY_CFGS[name]
        if kind == "s":
            got = stream_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN)
            assert got == stream_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN, esize=4)
        else:
            got = launch_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN, temporal=kind)
            assert got == launch_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN, temporal=kind, esize=4)
        assert tuple(got) == want, (name, b, kind)


@pytest.mark.parametrize("name,cfg", FULL_HD + [("r2", BGConfig(2, 4.0, 50.0))])
def test_bf16_geometries_fit_and_take_less_shared_memory(name, cfg):
    """bf16 slots and rings hold 2-byte pixels: every full-HD launch fits,
    takes no more shared memory per block than fp32's at the same knobs, and
    B3's ring rows stay a multiple of 8 (16 bytes of bf16)."""
    for b in (1, 4, 8):
        for temporal in (False, True):
            g16 = launch_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN, temporal=temporal, esize=2)
            assert g16.smem <= H100_SMEM_OPTIN
            same = smem_bytes(g16.band, g16.tile, g16.rows, cfg.r, K.grid_shape(1080, 1920, cfg)[2], temporal)
            assert g16.smem <= same
        s16 = stream_geometry(b, 1080, 1920, cfg, 132, H100_SMEM_OPTIN, esize=2)
        gz = K.grid_shape(1080, 1920, cfg)[2]
        assert s16.smem <= H100_SMEM_OPTIN and s16.ring_rows % 8 == 0
        assert s16.smem == stream_smem_bytes(s16.tile, s16.chunk, cfg.r, gz, esize=2)
        assert s16.smem <= stream_smem_bytes(s16.tile, s16.chunk, cfg.r, gz) + 4 * s16.ring_rows * 8


BF16_CARD = [((37, 53), BGConfig(4, 3.0, 50.0)), ((19, 26), BGConfig(4, 3.0, 50.0)),
             ((40, 55), SERVE_CONFIG), ((36, 48), SERVE_CONFIG), ((61, 83), BGConfig(7, 4.0, 50.0))]


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape,cfg", BF16_CARD)
def test_bf16_kernels_bitwise_plain_on_card(cuda, shape, cfg, b):
    """B1, B2 and B3 in bf16 equal their bf16 plain version bit for bit at
    small ragged and odd shapes; B3 equals B1; B2 after a cold pack, then at
    alphas (0, 0.6, 0.8), image and carry, its alpha-0 rows equal to B1's;
    only the bf16 counters count."""
    bf = torch.bfloat16
    x = torch.from_numpy(noisy_np(b, *shape)).to(cuda).to(bf)
    x2 = torch.from_numpy(noisy_np(b, *shape, seed=9)).to(cuda).to(bf)
    gx, gy, gz = K.grid_shape(*shape, cfg)
    before = {c: getattr(bg_fused, c) for c in ("launches", "temporal_launches", "streamed_launches",
                                              "bf16_launches", "bf16_temporal_launches",
                                              "bf16_streamed_launches")}
    k = bg_fused(x, cfg, precision="bf16")
    s = bg_fused(x, cfg, precision="bf16", stream_input=True)
    zero = torch.zeros((b, gx, gy, gz, 2), device=cuda, dtype=bf)
    o0, c0 = bg_fused(x, cfg, carry=zero, alpha=torch.zeros(b, device=cuda), precision="bf16")
    alpha = torch.tensor([0.0, 0.6, 0.8][:b], device=cuda)
    o1, c1 = bg_fused(x2, cfg, carry=c0, alpha=alpha, precision="bf16")
    torch.cuda.synchronize()
    after = {c: getattr(bg_fused, c) - v for c, v in before.items()}
    assert after == {"launches": 0, "temporal_launches": 0, "streamed_launches": 0, "bf16_launches": 1,
                     "bf16_temporal_launches": 2, "bf16_streamed_launches": 1}
    assert all(t.dtype == bf for t in (k, s, o0, c0, o1, c1))
    assert torch.equal(k, bg_fused_plain(x, cfg, precision="bf16"))
    assert torch.equal(s, k) and torch.equal(o0, k)
    p0, pc0 = bg_fused_plain(x, cfg, carry=zero, alpha=torch.zeros(b, device=cuda), precision="bf16")
    assert torch.equal(c0, pc0)
    p1, pc1 = bg_fused_plain(x2, cfg, carry=c0, alpha=alpha, precision="bf16")
    assert torch.equal(o1, p1) and torch.equal(c1, pc1)
    assert torch.equal(o1[0], bg_fused(x2, cfg, precision="bf16")[0])
    # a frame alone equals its row of the batch; unaligned frame starts
    assert torch.equal(bg_fused(x[b - 1], cfg, precision="bf16"), k[b - 1])
    assert torch.equal(bg_fused(x[b - 1], cfg, precision="bf16", stream_input=True), k[b - 1])


@pytest.mark.gpu
def test_bf16_wrappers_raise_on_the_other_storage_type_on_card(cuda):
    cfg = BGConfig(4, 3.0, 50.0)
    x = torch.from_numpy(noisy_np(2, 19, 26)).to(cuda)
    gx, gy, gz = K.grid_shape(19, 26, cfg)
    carry = torch.zeros((2, gx, gy, gz, 2), device=cuda)
    alpha = torch.zeros(2, device=cuda)
    counts = (bg_fused.launches, bg_fused.bf16_launches, bg_fused.bf16_streamed_launches)
    for stream_input in (False, True):
        with pytest.raises(TypeError, match="float32 frames"):
            bg_fused(x.to(torch.bfloat16), cfg, stream_input=stream_input)
        with pytest.raises(TypeError, match="bfloat16 frames"):
            bg_fused(x, cfg, precision="bf16", stream_input=stream_input)
    with pytest.raises(TypeError, match="bfloat16 carry"):
        bg_fused(x.to(torch.bfloat16), cfg, carry=carry, alpha=alpha, precision="bf16")
    with pytest.raises(TypeError, match="float32 carry"):
        bg_fused(x, cfg, carry=carry.to(torch.bfloat16), alpha=alpha)
    assert (bg_fused.launches, bg_fused.bf16_launches, bg_fused.bf16_streamed_launches) == counts


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["alone", "odd_start", "nan_neighbours"])
def test_bf16_kernels_odd_element_count_on_card(cuda, layout):
    """A 1x37x53 bf16 frame has an odd element count: its last row ends in
    the middle of a 4-byte word, and as a view one element into a buffer its
    first row starts in the middle of one. B1, B2 and B3 copy those words
    whole and never read their other half: they equal their plain version
    bit for bit, and NaN elements just outside the frame reach no output
    pixel."""
    cfg = BGConfig(4, 3.0, 50.0)
    bf = torch.bfloat16
    clean = torch.from_numpy(noisy_np(1, 37, 53)).to(cuda).to(bf)
    n = clean.numel()
    if layout == "alone":
        x = clean.clone()
    else:
        base = torch.full((n + 2,), float("nan") if layout == "nan_neighbours" else 7.0,
                          device=cuda, dtype=bf)
        x = base[1:n + 1].view(1, 37, 53)
        x.copy_(clean)
        assert x.data_ptr() % 4 == 2 and x.is_contiguous()
    assert n % 2 == 1
    gx, gy, gz = K.grid_shape(37, 53, cfg)
    zero = torch.zeros((1, gx, gy, gz, 2), device=cuda, dtype=bf)
    alpha = torch.zeros(1, device=cuda)
    want = bg_fused_plain(clean, cfg, precision="bf16")
    pwant, pcarry = bg_fused_plain(clean, cfg, carry=zero, alpha=alpha, precision="bf16")
    assert torch.equal(bg_fused(x, cfg, precision="bf16"), want)
    assert torch.equal(bg_fused(x, cfg, precision="bf16", stream_input=True), want)
    o, c = bg_fused(x, cfg, carry=zero, alpha=alpha, precision="bf16")
    assert torch.equal(o, pwant) and torch.equal(c, pcarry)
    assert bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(c.float()).all())


def planted_frames(b: int, h: int, w: int, r: int) -> torch.Tensor:
    """``b`` >= 5 float32 frames for the quantizing store: noisy scenes with
    a dark block (intensity 10) holding a NaN (frame 0), +inf (frame 1) or
    -inf (frame 2) pixel, which the filter spreads into NaN and +-inf
    outputs; flat frames at x.5 intensities (frame 3: 100.5 over 255.5;
    frame 4: -0.5 beside 37.5), which it maps onto x.5 or within a few ulps
    of it, and past both ends of the clamp."""
    x = torch.from_numpy(noisy_np(b, h, w, seed=11))
    rows, cols = slice(h // 4, h // 4 + 3 * r), slice(w // 4, w // 4 + 3 * r)
    for i, v in enumerate((float("nan"), float("inf"), float("-inf"))):
        x[i, rows, cols] = 10.0
        x[i, h // 4 + 3 * r // 2, w // 4 + 3 * r // 2] = v
    x[3, :h // 2], x[3, h // 2:] = 100.5, 255.5
    x[4, :, :w // 2], x[4, :, w // 2:] = -0.5, 37.5
    return x


QUANT_CARD = [((61, 83), BGConfig(7, 4.0, 50.0)), ((1080, 1920), PAPER_DEFAULT.bg)]


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("entry", ["B1", "B2", "B3"])
@pytest.mark.parametrize("shape,cfg", QUANT_CARD, ids=["61x83-r7", "1080x1920-r12"])
def test_quantizing_store_equals_quantize_intensity_on_card(cuda, shape, cfg, entry, precision):
    """Each of the six entry points with ``quantize=True`` equals
    ``quantize_intensity`` of its own ``quantize=False`` output (upcast for
    bf16), NaN positions and +-inf included, at batch tiles that do not
    divide the batch; the carry is not quantized; ``quantized_launches``
    counts each quantizing launch."""
    b = 5
    sdt = storage_dtype(precision)
    x = planted_frames(b, *shape, cfg.r).to(cuda).to(sdt)
    kw = dict(precision=precision, stream_input=entry == "B3")
    if entry == "B2":
        _, carry, _ = temporal_inputs(b, *shape, cfg, cuda)
        kw.update(carry=carry.to(sdt), alpha=torch.tensor([0.0, 0.4, 0.6, 0.8, 0.5], device=cuda))
    for bt in (None, 2, 3):
        launches = bg_fused.quantized_launches
        raw = bg_fused(x, cfg, batch_tile=bt, **kw)
        got = bg_fused(x, cfg, batch_tile=bt, quantize=True, **kw)
        torch.cuda.synchronize()
        assert bg_fused.quantized_launches == launches + (1 if bt is None else -(-b // bt))
        if entry == "B2":
            (raw, raw_carry), (got, got_carry) = raw, got
            assert same_or_nan(got_carry.float(), raw_carry.float())
        assert got.dtype == sdt
        assert same_or_nan(got.float(), quantize_intensity(raw.float(), cfg)), bt
    f = raw.float()
    assert bool(f.isnan().any()) and bool((f == float("inf")).any()) and bool((f == float("-inf")).any())
    assert bool(((f - f.floor() - 0.5).abs() <= 1e-4).any())
    q = got.float()
    assert bool((q == 255.0).any()) and bool((q == 0.0).any())
    assert finite_rows(got).tolist() == [False, False, False, True, True]


@pytest.mark.gpu
@pytest.mark.parametrize("precision,kernels", [("fp32", 1), ("bf16", 3)])
@pytest.mark.parametrize("backend,temporal", [("fused", False), ("fused_streamed", False), ("fused", True)],
                         ids=["B1", "B3", "B2"])
def test_fused_plan_dispatch_has_no_quantization_pass_on_card(cuda, backend, temporal, precision, kernels):
    """A fused plan's dispatch of card frames runs its kernel alone (fp32),
    or the kernel between the frames' cast to bf16 and the output's upcast
    (bf16), whether it quantizes or not: the quantization is in the
    kernel's store, not three elementwise passes after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.plan import BGPlan

    cfg = BGConfig(7, 4.0, 50.0)
    x = torch.from_numpy(noisy_np(4, 61, 83)).to(cuda)
    kw = {}
    if temporal:
        _, carry, alpha = temporal_inputs(4, 61, 83, cfg, cuda)
        kw = dict(carry=carry.to(storage_dtype(precision)), alpha=alpha)
    outs = {}
    for quantize in (False, True):
        plan = BGPlan(cfg, backend=backend, temporal=temporal, precision=precision,
                      quantize_output=quantize, device=cuda)
        plan(x, **kw)  # builds and caches outside the profiled call
        torch.cuda.synchronize()
        launches = bg_fused.quantized_launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = plan(x, **kw)
            torch.cuda.synchronize()
        ops = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
        assert len(ops) == kernels, ops
        assert bg_fused.quantized_launches == launches + quantize
        outs[quantize] = out[0] if temporal else out
    assert torch.equal(outs[True], quantize_intensity(outs[False], cfg))
