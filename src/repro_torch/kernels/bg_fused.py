"""Fused GC -> GF -> TI bilateral-grid filter: the CUDA kernels' wrapper and
their plain PyTorch version, per frame, temporal and streamed.

The kernel (``csrc/bg_fused.cu``) replaces the JAX package's fused Pallas
kernel (``repro/kernels/bg_fused.py::_kernel``) in both of its launches: per
frame (``:645``, B1) and temporal (``:569``, B2). It computes, per frame, the
paper's grid creation, Gaussian grid filter with per-cell normalization and
trilinear slice, unquantized, with the grid held in shared memory and never
written to HBM. The temporal launch (``carry=`` and ``alpha=``) blends each
blurred homogeneous plane with the frame's carry, ``B' = (1-a) B + a C``,
before TI reads it, and returns ``B'`` as the new carry. ``stream_input=True``
runs the streamed kernel (``csrc/bg_fused_streamed.cu``, B3), which replaces
``_stream_kernel`` (``:620``): the same filter with each frame read from HBM
once, streamed through a ring of rows in shared memory that TI reads too,
equal to B1 bit for bit.
See the sources for the designs.

Storage precision. ``precision="fp32"`` (the default) stores everything in
float32. ``precision="bf16"`` is the JAX package's bf16 storage form
(``bg_fused_impl(precision="bf16")``): the frames, the carry and the output
are ``torch.bfloat16`` tensors, and every contraction accumulates in fp32.
The port's bf16 contract, which the kernels and :func:`bg_fused_plain` both
follow, rounding to nearest even (``tensor.to(torch.bfloat16)``,
``__float2bfloat16_rn``):

  1. Frame: the kernel reads bf16 frames from HBM (8-bit frames are exact).
  2. Raw grid: GC sums each cell in fp32, in ``bg::gc_cell``'s order with
     no atomics; the complete cell (count and sum) is rounded to bf16.
  3. Blur: GF reads the rounded raw planes and blurs in fp32 (``bg::tap3``).
  4. Temporal only: the blend reads the bf16 carry, upcast, keeps B2's
     rounding (each product and the sum on its own) and writes the carry
     out as bf16.
  5. Normalize: fp32, from the unrounded blurred (blended) value; the
     normalized plane is rounded to bf16.
  6. TI reads the rounded normalized planes. Its z lerp takes the two
     weights ``1 - zf`` and ``zf`` each rounded to bf16 (``bg::zlerp``; the
     TPU kernel stores its z weights in bf16); the y and x lerps stay fp32.
  7. Output: stored as bf16; the plan upcasts it to float32 before
     ``quantize_intensity``.

It differs from the TPU kernel's in two places, because the port's GC sums
a cell whole: the TPU kernel rounds a partial plane at each stripe boundary
(``_pipeline_step``, ``:267`` then ``:197``), and it uses the current raw
plane unrounded once, in GF of the plane before it (``r0``, ``:197-200``).
The port does neither. The tests hold the two to the JAX package's own bf16
tolerances, not bit for bit; inside the port the kernels equal
:func:`bg_fused_plain` bit for bit in both precisions. Each storage type has
its own C entry points and launch counters; a tensor of the other type
raises.

Dispatch follows the tensor's device and nothing else:

  * a CPU tensor goes to :func:`bg_fused_plain`;
  * a CUDA tensor goes to the kernel, or the wrapper raises.

There is no fallback from the kernel to the plain version. The plain version
is the reference the tests and ``chip_smoke.py`` hold the kernel to.

Per-frame results depend on nothing but the frame (and its carry row and
alpha): not on the batch it shares, not on ``batch_tile``, not on how the
kernel cuts the frame into bands of stripes and tiles of columns (a block
recomputes its halo planes and cells with the same code as its neighbours),
not on ``stream_input``, and not on the launch (no float atomics). An ``alpha == 0`` row of a temporal call equals the
per-frame call bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bilateral_grid import grid_normalize

from repro_torch.reliability.errors import KernelLaunchError

from . import _build, _wrap
from .bg_blur import bg_blur_plain
from .bg_create import bg_create_plain, bin_divisor
from .bg_slice import bg_slice_plain
from .common import BGConfig, gc_row_split, grid_shape, round_storage, storage_dtype, taps_np

__all__ = [
    "bg_fused",
    "bg_fused_plain",
    "Geometry",
    "launch_geometry",
    "smem_bytes",
    "StreamGeometry",
    "stream_geometry",
    "stream_smem_bytes",
]

KERNEL = "bg_fused"
STREAM_KERNEL = "bg_fused_streamed"
# cudaDevAttrMaxSharedMemoryPerBlockOptin of the H100; the wrapper asks the
# card it launches on, the tests use this value for the geometry rules
H100_SMEM_OPTIN = 232448
# shared memory the card reserves for each resident block
_SMEM_PER_BLOCK = 1024
# B1/B2's split rule (launch_geometry), set from the sweep of its knobs at
# b = 1, 4 and 8 on an H100 (chip_smoke.py, phase "kernel_sweep";
# PERF.md has the numbers): column tiles about _TILE_PX pixels wide; bands
# of b * n * tiles // (_BLOCKS_PER_SM * SMs) stripes, 1 to _MAX_BAND; GC
# steps of the most rows, up to _MAX_ROWS, that keep every block of the
# launch resident at once. A block has THREADS threads (the kernel's
# kThreads).
_TILE_PX = 480
_BLOCKS_PER_SM = 2.5
_MAX_BAND = 6
_MAX_ROWS = 4
THREADS = 256
# B3's rule (stream_geometry): B1's column tiles (half as wide for a single
# frame), the deepest chunks that
# keep _STREAM_BLOCKS_PER_SM blocks resident, GC tasks of the most z bins
# that leave a plane _STREAM_GC_TASKS tasks, and the shortest band whose
# blocks are all resident at once; a block has THREADS threads, an SM holds
# at most _MAX_BLOCKS_PER_SM of them (2048 threads). chip_smoke.py's phase
# "stream_sweep" sweeps the knobs.
_STREAM_BLOCKS_PER_SM = 2
_STREAM_GC_TASKS = 64
_MAX_BLOCKS_PER_SM = 8


class StreamGeometry(NamedTuple):
    """One B3 launch: ``band`` stripes x ``tile`` column cells per block,
    ``bands`` x ``tiles`` blocks per frame, chunks of ``chunk`` rows, GC
    tasks of ``zgroup`` z bins, a ring of ``ring_rows`` rows, ``smem`` bytes
    of dynamic shared memory per block."""

    band: int
    bands: int
    tile: int
    tiles: int
    chunk: int
    zgroup: int
    ring_rows: int
    smem: int


class Geometry(NamedTuple):
    """One B1/B2 launch: ``band`` stripes x ``tile`` column cells per block,
    ``bands`` x ``tiles`` blocks per frame, GC steps of ``rows`` rows of
    every raw plane, ``smem`` bytes of dynamic shared memory per block."""

    band: int
    bands: int
    tile: int
    tiles: int
    rows: int
    smem: int


# ----------------------------------------------------------------- plain
def bg_fused_plain(
    image: torch.Tensor,
    cfg: BGConfig,
    batch_tile: Optional[int] = None,
    carry: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    precision: str = "fp32",
):
    """Plain PyTorch version of the fused kernels, on any device.

    Batched whole-image GC -> GF -> normalize -> TI in fp32 tensor ops: the
    staged plain versions (:func:`bg_create_plain`, :func:`bg_blur_plain`,
    ``grid_normalize``, :func:`bg_slice_plain`), which carry the kernels'
    arithmetic: z bin ``floor(px / rs + 0.5)`` (the reference's), integer
    row and column cells, blur along x, then z, then y, and the kernels' TI lerp
    order. It uses no matmul and no convolution, so TF32 settings do not
    reach it. ``batch_tile`` bounds the frames per pass (memory only; the
    result does not depend on it). With ``carry`` and ``alpha`` it is the
    temporal version and returns ``(out, new_carry)`` (see :func:`bg_fused`).
    It is the plain version of the streamed kernel too, which equals B1.
    ``precision="bf16"`` takes and returns bf16 tensors and rounds where the
    module docstring's contract says.
    """
    _check_batch_tile(batch_tile)
    x, carry, alpha = _operands(image, cfg, carry, alpha, precision)
    b = x.shape[0]
    bt = b if batch_tile is None else min(batch_tile, b)
    if carry is None:
        out = torch.cat([_plain_frames(x[i:i + bt], cfg, precision=precision)
                         for i in range(0, b, bt)])
        return out[0] if image.dim() == 2 else out
    parts = [
        _plain_frames(x[i:i + bt], cfg, carry[i:i + bt], alpha[i:i + bt], precision)
        for i in range(0, b, bt)
    ]
    out = torch.cat([p[0] for p in parts])
    new_carry = torch.cat([p[1] for p in parts])
    return (out[0], new_carry[0]) if image.dim() == 2 else (out, new_carry)


def _plain_frames(x: torch.Tensor, cfg: BGConfig, carry=None, alpha=None, precision="fp32"):
    # every step in fp32; the round_storage calls are the bf16 contract's
    # rounding points (the identity for fp32)
    sdt = storage_dtype(precision)
    x = x.to(torch.float32)
    raw = round_storage(bg_create_plain(x, cfg), precision)  # (b, gx, gy, gz, 2)
    blurred = bg_blur_plain(raw, cfg)
    if carry is not None:
        # ---- temporal EMA of the blurred homogeneous grid, the kernel's
        # rounding: each product and the sum rounded on its own
        a = alpha.reshape(-1, 1, 1, 1, 1)
        blurred = (1.0 - a) * blurred + a * carry.to(torch.float32)
    norm = round_storage(grid_normalize(blurred), precision)
    out = bg_slice_plain(norm, x, cfg, zweight_dtype=sdt).to(sdt)
    return out if carry is None else (out, blurred.to(sdt))


# ---------------------------------------------------------------- kernel
def smem_bytes(band: int, tile: int, rows: int, r: int, gz: int, temporal: bool = False,
               esize: int = 4) -> int:
    """Dynamic shared memory of one block that owns ``band`` stripes and
    ``tile`` column cells: raw planes (count, sum) k0-1 .. k1+1 over raw
    cells c0-1 .. c1+1 (a temporal launch one more plane, for the drain
    when ``h % r == 0``), normalized planes k0 .. k1 over cells c0 .. c1,
    and two GC slots of ``rows`` rows of every raw plane that has rows,
    which TI reuses for each thread's y-lerped corners (two planes, every
    z). Frames of ``esize`` bytes: fp32 slots hold ``r`` columns per raw
    cell, transposed, the cell stride made odd; bf16 slots (``esize=2``)
    hold each row as it lies in HBM, ``(tile + 3) * r + 2`` pixels made
    even, each slot to 16 bytes. The planes are fp32 either way."""
    t = int(temporal)
    nr = tile + 3
    if esize == 4:
        slot = (band + 3) * rows * r * (nr | 1)
    else:
        slot = -(-(band + 3) * rows * ((nr * r + 3) & ~1) * esize // 16) * 4
    slots = max(2 * slot, 2 * gz * THREADS)
    return 4 * ((band + 3 + t) * 2 * gz * nr + gz * (tile + 1) * (band + 1) + slots)


def launch_geometry(
    b: int,
    h: int,
    w: int,
    cfg: BGConfig,
    num_sms: int,
    smem_limit: int,
    band: Optional[int] = None,
    temporal: bool = False,
    tile: Optional[int] = None,
    rows: Optional[int] = None,
    esize: int = 4,
) -> Geometry:
    """The :class:`Geometry` of a B1 (or, ``temporal``, B2) launch over
    ``b`` frames of ``esize``-byte elements (4: fp32, 2: bf16).

    Defaults: column tiles of ``ceil(_TILE_PX / r)`` cells; ``band`` =
    ``b * n * tiles // (_BLOCKS_PER_SM * num_sms)`` stripes, 1 to
    ``_MAX_BAND``; ``rows``, the most (up to ``_MAX_ROWS``) that keep all
    the launch's blocks resident on the card at once, ``smem_limit`` bytes
    of shared memory per SM, else 1. What does not fit ``smem_limit`` is
    cut: rows first, then the band, then the tile; a block of one stripe,
    one cell and one row that still does not fit raises ``ValueError``
    naming the bytes.
    """
    _, gy, gz = grid_shape(h, w, cfg)
    r = cfg.r
    n = -(-h // r)
    nc = -(-w // r)
    need = smem_bytes(1, 1, 1, r, gz, temporal, esize)
    if need > smem_limit:
        raise ValueError(
            f"bg_fused: one stripe and one column cell of a {h}x{w} frame at "
            f"r={r} (gz={gz}{', temporal' if temporal else ''}) need {need} "
            f"bytes of shared memory per block, above the card's {smem_limit}"
        )
    tile = max(1, min(-(-_TILE_PX // r) if tile is None else tile, nc))
    tiles = -(-nc // tile)
    if band is None:
        band = min(_MAX_BAND, (b * n * tiles) // int(_BLOCKS_PER_SM * num_sms))
    band = max(1, min(band, n))
    if rows is None:
        blocks = b * -(-n // band) * tiles
        rows = next((k for k in range(min(_MAX_ROWS, r), 1, -1)
                     if smem_limit // (smem_bytes(band, tile, k, r, gz, temporal, esize)
                                       + _SMEM_PER_BLOCK)
                     * num_sms >= blocks), 1)
    rows = max(1, min(rows, r))
    while smem_bytes(band, tile, rows, r, gz, temporal, esize) > smem_limit:
        if rows > 1:
            rows -= 1
        elif band > 1:
            band -= 1
        else:
            tile = -(-tile // 2)
    return Geometry(band, -(-n // band), tile, -(-nc // tile), rows,
                    smem_bytes(band, tile, rows, r, gz, temporal, esize))


def ring_rows(r: int, chunk: int, esize: int = 4) -> int:
    """Rows of B3's ring: TI of stripe k reads its r rows once raw plane
    k+2 is complete, with the next chunk in flight: 2r + split + chunk,
    rounded up to a multiple of ``16 // esize`` (4 fp32, 8 bf16: so that
    every ring row keeps its HBM row's 16-byte alignment)."""
    e = 16 // esize
    return -(-(2 * r + gc_row_split(r) + chunk) // e) * e


def stream_smem_bytes(tile: int, chunk: int, r: int, gz: int, esize: int = 4) -> int:
    """Dynamic shared memory of one streamed block over ``tile`` column
    cells: a ring of four raw planes (count, sum) over raw cells c0-1 ..
    c1+1, two normalized planes over cells c0 .. c1, each TI thread's table
    of y-lerped corners (two planes, every z), a plane's x-mixed values
    (count, sum over the raw cells) and TI's r x fractions; then, from the
    next
    16-byte boundary, the ring of :func:`ring_rows` rows of the window in
    ``esize``-byte elements (fp32: ``tile + 3`` cells of ``r`` columns, plus
    up to three floats of alignment, to a multiple of 4, plus up to three for
    the frame width; bf16: plus eight of alignment and a word's half, to a
    multiple of 8, plus up to seven) and a chunk's z bin bytes, ``ceil(r /
    4)`` words per cell made odd."""
    nr = tile + 3
    head = -(-(5 * 2 * gz * nr + 2 * gz * (tile + 1) + 2 * gz * THREADS + r) // 4) * 4
    if esize == 4:
        row = -(-(nr * r + 3) // 4) * 4 + 3
    else:
        row = (nr * r + 15) // 8 * 8 + 7
    zbins = chunk * nr * ((-(-r // 4)) | 1)
    return 4 * (head + zbins) + ring_rows(r, chunk, esize) * row * esize


def _one_wave_band(b: int, n: int, tiles: int, slots: int) -> int:
    """The shortest band of stripes (of ``n`` per frame) whose blocks, ``b *
    ceil(n / band) * tiles`` of them, all fit in ``slots`` resident blocks
    at once (one wave); ``n`` when none does."""
    return -(-n // max(1, slots // (b * tiles)))


def stream_geometry(
    b: int,
    h: int,
    w: int,
    cfg: BGConfig,
    num_sms: int,
    smem_limit: int,
    band: Optional[int] = None,
    tile: Optional[int] = None,
    chunk: Optional[int] = None,
    zgroup: Optional[int] = None,
    esize: int = 4,
) -> StreamGeometry:
    """The :class:`StreamGeometry` of a streamed (B3) launch over ``b``
    frames of ``esize``-byte elements (4: fp32, 2: bf16).

    Defaults: column tiles of ``ceil(_TILE_PX / r)`` cells, halved once
    when ``b`` frames of single-stripe blocks would fill fewer than two
    waves of ``_STREAM_BLOCKS_PER_SM`` blocks per SM, and halved until a
    block with one-row chunks fits ``smem_limit``; chunks of the most rows,
    at most r, that keep ``_STREAM_BLOCKS_PER_SM`` blocks resident per SM
    (or as many as one-row chunks do, if fewer; an explicit chunk is cut to
    what fits); GC tasks of ``zgroup`` z bins, the most of 4, 2, 1 that
    still give a plane ``_STREAM_GC_TASKS`` tasks; the shortest band whose
    blocks are all resident at once. A frame
    whose one-cell tile with one-row chunks does not fit, or whose grid has
    more than 255 z bins (a bin is a byte), raises ``ValueError``, naming
    the bytes for the first.
    """
    _, gy, gz = grid_shape(h, w, cfg)
    r = cfg.r
    n = -(-h // r)
    nc = -(-w // r)
    need = stream_smem_bytes(1, 1, r, gz, esize)
    if need > smem_limit:
        raise ValueError(
            f"bg_fused(stream_input=True): one column cell of a {h}x{w} frame at "
            f"r={r} (gz={gz}) with one-row chunks needs {need} bytes of shared "
            f"memory per block, above the card's {smem_limit}"
        )
    if gz > 255:
        raise ValueError(f"bg_fused(stream_input=True): gz={gz} z bins do not fit a byte")
    if tile is None:
        tile = -(-_TILE_PX // r)
        if b * n * -(-nc // tile) < 2 * _STREAM_BLOCKS_PER_SM * num_sms:  # small batch: narrower tiles
            tile = -(-tile // 2)
    tile = max(1, min(tile, nc))
    while stream_smem_bytes(tile, 1, r, gz, esize) > smem_limit:
        tile = -(-tile // 2)
    per_sm = lambda c: max(1, min(_MAX_BLOCKS_PER_SM,
                                  smem_limit // (stream_smem_bytes(tile, c, r, gz, esize)
                                                 + _SMEM_PER_BLOCK)))
    if chunk is None:
        keep = min(_STREAM_BLOCKS_PER_SM, per_sm(1))
        chunk = max(c for c in range(1, r + 1) if per_sm(c) >= keep)
    chunk = max(1, min(chunk, r))
    while stream_smem_bytes(tile, chunk, r, gz, esize) > smem_limit:
        chunk -= 1
    tiles = -(-nc // tile)
    if zgroup is None:
        zgroup = next((k for k in (4, 2) if (tile + 3) * -(-gz // k) >= _STREAM_GC_TASKS), 1)
    if zgroup not in (1, 2, 4):
        raise ValueError(f"bg_fused(stream_input=True): zgroup must be 1, 2 or 4, got {zgroup}")
    if band is None:
        band = _one_wave_band(b, n, tiles, per_sm(chunk) * num_sms)
    band = max(1, min(band, n))
    return StreamGeometry(band, -(-n // band), tile, tiles, chunk, zgroup,
                          ring_rows(r, chunk, esize), stream_smem_bytes(tile, chunk, r, gz, esize))


class LaunchShape(ctypes.Structure):
    """``csrc/bg_fused.cu``'s ``LaunchShape``: a launch's shape and geometry,
    built once per shape and passed by pointer."""

    _fields_ = [(f, ctypes.c_int) for f in ("b", "h", "w", "r", "gx", "gy", "gz", "split", "band",
                                            "tile", "rows")] + \
               [(f, ctypes.c_float) for f in ("inv_rs", "rs", "rcp_rs", "t0", "t1", "t2")] + \
               [(f, ctypes.c_int) for f in ("smem_bytes", "device")]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load(KERNEL, {
        "bg_fused_launch": ([p] * 6, i),
        "bg_fused_temporal_launch": ([p] * 9, i),
        "bg_fused_bf16_launch": ([p] * 6, i),
        "bg_fused_temporal_bf16_launch": ([p] * 9, i),
        "bg_fused_smem_optin": ([i], i),
    })


class StreamShape(ctypes.Structure):
    """``csrc/bg_fused_streamed.cu``'s ``StreamShape``: a B3 launch's shape
    and geometry, built once per shape and passed by pointer."""

    _fields_ = [(f, ctypes.c_int) for f in ("b", "h", "w", "r", "gy", "gz", "split", "band", "tile",
                                            "chunk", "zgroup", "ring_rows")] + \
               [(f, ctypes.c_float) for f in ("inv_rs", "rs", "rcp_rs", "t0", "t1", "t2")] + \
               [(f, ctypes.c_int) for f in ("smem_bytes", "device")]


@functools.lru_cache(maxsize=None)
def _stream_lib() -> ctypes.CDLL:
    sig = ([ctypes.c_void_p] * 6, ctypes.c_int)
    return _build.load(STREAM_KERNEL, {"bg_fused_streamed_launch": sig,
                                       "bg_fused_streamed_bf16_launch": sig})


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int]:
    """(SM count, opt-in shared memory per block) of CUDA device ``index``."""
    smem = _lib().bg_fused_smem_optin(index)
    if smem <= 0:
        raise KernelLaunchError(f"bg_fused: cannot query shared memory of cuda:{index}")
    return torch.cuda.get_device_properties(index).multi_processor_count, smem


@functools.lru_cache(maxsize=256)
def _launch_args(b: int, h: int, w: int, cfg: BGConfig, index: int, temporal: bool, band, knobs,
                 esize: int = 4) -> tuple:
    """``(geometry, shape, address)``: the launch's :class:`Geometry`, its
    :class:`LaunchShape` (kept alive by the cache) and that struct's
    address, cached per shape, config, knobs and element size (a launch's
    host work is a visible share of a launch)."""
    num_sms, smem_limit = _device_limits(index)
    geo = launch_geometry(b, h, w, cfg, num_sms, smem_limit, band, temporal, esize=esize,
                          **dict(knobs))
    gx, gy, gz = grid_shape(h, w, cfg)
    t0, t1, t2 = (float(t) for t in taps_np(cfg))
    shape = LaunchShape(b, h, w, cfg.r, gx, gy, gz, gc_row_split(cfg.r), geo.band, geo.tile,
                        geo.rows, float(np.float32(1.0 / cfg.range_scale)), *bin_divisor(cfg),
                        t0, t1, t2, geo.smem, index)
    return geo, shape, ctypes.addressof(shape)


def _launch(
    x: torch.Tensor,
    out: torch.Tensor,
    cfg: BGConfig,
    band=None,
    carry: Optional[torch.Tensor] = None,
    carry_out: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    **knobs,
) -> Geometry:
    """One kernel launch over the contiguous (b, h, w) CUDA frames ``x``:
    B1, or B2 when ``carry`` is given (with ``carry_out`` and ``alpha``),
    the fp32 or the bf16 entry point by ``x``'s dtype (the carries and
    ``out`` are of that dtype too). ``band`` and ``knobs`` (``tile``,
    ``rows``) override :func:`launch_geometry`'s rule (for sweeps); returns
    the geometry launched."""
    b, h, w = x.shape
    dev = x.device
    temporal = carry is not None
    bf16 = x.dtype == torch.bfloat16
    geo, _, shape = _launch_args(b, h, w, cfg, dev.index, temporal, band,
                                 tuple(sorted(knobs.items())), x.element_size())
    yf, xf = _wrap.ti_fracs(w, cfg.r, dev)
    lib = _lib()
    if temporal:
        fn = lib.bg_fused_temporal_bf16_launch if bf16 else lib.bg_fused_temporal_launch
        err = fn(
            x.data_ptr(), out.data_ptr(), carry.data_ptr(), carry_out.data_ptr(),
            alpha.data_ptr(), yf.data_ptr(), xf.data_ptr(), shape, _wrap.stream(dev),
        )
    else:
        fn = lib.bg_fused_bf16_launch if bf16 else lib.bg_fused_launch
        err = fn(x.data_ptr(), out.data_ptr(), yf.data_ptr(), xf.data_ptr(), shape, _wrap.stream(dev))
    _build.check(KERNEL, err)
    if temporal and bf16:
        _wrap.count(bg_fused, "bf16_temporal_launches")
    elif temporal:
        _wrap.count(bg_fused, "temporal_launches")
    elif bf16:
        _wrap.count(bg_fused, "bf16_launches")
    else:
        _wrap.count(bg_fused, "launches")
    return geo


@functools.lru_cache(maxsize=256)
def _stream_args(b: int, h: int, w: int, cfg: BGConfig, index: int, knobs, esize: int = 4) -> tuple:
    """``(geometry, shape, address)`` of a B3 launch, cached per shape,
    config, knobs and element size, as :func:`_launch_args` is for B1."""
    num_sms, smem_limit = _device_limits(index)
    geo = stream_geometry(b, h, w, cfg, num_sms, smem_limit, esize=esize, **dict(knobs))
    _, gy, gz = grid_shape(h, w, cfg)
    t0, t1, t2 = (float(t) for t in taps_np(cfg))
    shape = StreamShape(b, h, w, cfg.r, gy, gz, gc_row_split(cfg.r), geo.band, geo.tile, geo.chunk,
                        geo.zgroup, geo.ring_rows, float(np.float32(1.0 / cfg.range_scale)),
                        *bin_divisor(cfg), t0, t1, t2, geo.smem, index)
    return geo, shape, ctypes.addressof(shape)


def _stream_launch(x: torch.Tensor, out: torch.Tensor, cfg: BGConfig, **knobs) -> StreamGeometry:
    """One streamed kernel launch (B3) over the contiguous (b, h, w) CUDA
    frames ``x``, the fp32 or the bf16 entry point by ``x``'s dtype;
    ``knobs`` (``band``, ``tile``, ``chunk``, ``zgroup``) override
    :func:`stream_geometry`'s rule (for sweeps); returns the geometry
    launched."""
    b, h, w = x.shape
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    geo, _, shape = _stream_args(b, h, w, cfg, dev.index, tuple(sorted(knobs.items())),
                                 x.element_size())
    yf, xf = _wrap.ti_fracs(w, cfg.r, dev)
    lib = _stream_lib()
    fn = lib.bg_fused_streamed_bf16_launch if bf16 else lib.bg_fused_streamed_launch
    err = fn(x.data_ptr(), out.data_ptr(), yf.data_ptr(), xf.data_ptr(), shape, _wrap.stream(dev))
    _build.check(STREAM_KERNEL, err)
    if bf16:
        _wrap.count(bg_fused, "bf16_streamed_launches")
    else:
        _wrap.count(bg_fused, "streamed_launches")
    return geo


def bg_fused(
    image: torch.Tensor,
    cfg: BGConfig,
    batch_tile: Optional[int] = None,
    carry: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    stream_input: bool = False,
    precision: str = "fp32",
):
    """Fused BG filter, (h, w) -> (h, w) or (b, h, w) -> (b, h, w), in the
    storage type, unquantized, paper normalization.

    ``carry`` + ``alpha`` select the temporal path (the JAX package's
    ``bg_fused_impl(carry=, alpha=)``): ``carry`` is the ``(b, gx, gy, gz,
    2)`` float32 blurred-grid EMA state, one row per frame, ``alpha`` the
    ``(b,)`` float32 blend weights; the call then returns ``(out,
    new_carry)``, with ``new_carry`` a fresh tensor. An ``(h, w)`` frame
    takes a ``(gx, gy, gz, 2)`` carry and a one-element alpha and squeezes
    both results.

    ``stream_input=True`` (``bg_fused_impl(stream_input=)``) runs the
    streamed kernel B3, equal to the default kernel bit for bit; it does not
    take a carry.

    ``precision="bf16"`` (module docstring) takes bf16 frames and a bf16
    carry and returns bf16 output and carry; alpha stays float32. Frames or
    a carry of the other storage type raise ``TypeError``: nothing is cast
    here.

    CPU tensors run :func:`bg_fused_plain`; CUDA tensors run the kernel, one
    launch per ``batch_tile`` frames (``None``: all frames in one launch), on
    the current stream. ``bg_fused.launches`` counts fp32 per-frame
    launches, ``bg_fused.temporal_launches`` temporal ones and
    ``bg_fused.streamed_launches`` streamed ones; ``bf16_launches``,
    ``bf16_temporal_launches`` and ``bf16_streamed_launches`` count the
    bf16 entry points.
    """
    _check_batch_tile(batch_tile)
    if cfg.normalize_mode != "paper":
        raise ValueError(
            f"bg_fused implements the paper normalization mode, got "
            f"{cfg.normalize_mode!r}"
        )
    if stream_input and carry is not None:
        raise ValueError("stream_input does not compose with a temporal carry")
    x, carry_b, alpha_b = _operands(image, cfg, carry, alpha, precision)
    if not _wrap.on_card(x, KERNEL):
        return bg_fused_plain(image, cfg, batch_tile, carry, alpha, precision)
    _wrap.contiguous(x, "frames", KERNEL)
    b, h, w = x.shape
    if b > 65535 or h * w >= 2**31:
        raise ValueError(f"bg_fused: {b} frames of {h}x{w} exceed one launch")
    out = torch.empty_like(x)
    bt = b if batch_tile is None else batch_tile
    if carry_b is None:
        launch = _stream_launch if stream_input else _launch
        for i in range(0, b, bt):
            launch(x[i:i + bt], out[i:i + bt], cfg)
        return out[0] if image.dim() == 2 else out
    for t, name in ((carry_b, "carry"), (alpha_b, "alpha")):
        if t.device != x.device:
            raise ValueError(f"bg_fused: {name} is on {t.device}, the frames on {x.device}")
        _wrap.contiguous(t, name, KERNEL)
    new_carry = torch.empty_like(carry_b)  # never aliased to the carry read
    for i in range(0, b, bt):
        s = slice(i, i + bt)
        _launch(x[s], out[s], cfg, carry=carry_b[s], carry_out=new_carry[s], alpha=alpha_b[s])
    return (out[0], new_carry[0]) if image.dim() == 2 else (out, new_carry)


bg_fused.launches = 0
bg_fused.temporal_launches = 0
bg_fused.streamed_launches = 0
bg_fused.bf16_launches = 0
bg_fused.bf16_temporal_launches = 0
bg_fused.bf16_streamed_launches = 0


def _operands(image, cfg: BGConfig, carry, alpha, precision: str = "fp32"):
    """``(frames, carry, alpha)`` with a leading frame axis, checked as the
    JAX package's ``bg_fused_impl`` checks them, frames and carry in the
    storage type of ``precision``; carry and alpha are ``None`` for a
    per-frame call."""
    sdt = storage_dtype(precision)
    x = _wrap.frames(image, KERNEL, sdt)
    if (carry is None) != (alpha is None):
        raise ValueError("temporal path needs both carry= and alpha= (or neither)")
    if carry is None:
        return x, None, None
    for t, name, dtype in ((carry, "carry", sdt), (alpha, "alpha", torch.float32)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"bg_fused takes a torch.Tensor {name}, got {type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"bg_fused takes a {str(dtype).replace('torch.', '')} {name}, "
                            f"got {t.dtype}")
    if image.dim() == 2:
        carry, alpha = carry[None], alpha.reshape(1)
    b, h, w = x.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    if tuple(carry.shape) != (b, gx, gy, gz, 2):
        raise ValueError(
            f"carry shape {tuple(carry.shape)} != {(b, gx, gy, gz, 2)} for "
            f"{(b, h, w)} frames"
        )
    if tuple(alpha.shape) != (b,):
        raise ValueError(f"alpha shape {tuple(alpha.shape)} != ({b},)")
    return x, carry, alpha


def _check_batch_tile(batch_tile) -> None:
    if batch_tile is not None and (
        isinstance(batch_tile, bool) or not isinstance(batch_tile, int) or batch_tile < 1
    ):
        raise ValueError(f"batch_tile must be a positive int or None, got {batch_tile!r}")
