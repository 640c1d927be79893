"""Streaming stripe pipeline, the paper's macro-pipeline (Fig. 4), in PyTorch.

The FPGA never holds the image or the full grid: it runs GC(x) || GF(x-1) ||
TI(x-2) over row-stripes of height r with a working set of three raw grid
planes, two blurred planes, and an r-line buffer. This module reproduces that
dataflow as a loop over ``n_stripes + 2`` stripes whose carry is exactly the
JAX package's ``lax.scan`` carry ``(R2, R1, Apart, B1, S2, S1)``
(``repro/core/streaming.py``), so peak memory is O(gy*gz + r*w) per frame
instead of O(h*w + gx*gy*gz). A batch is a leading axis of every carry
tensor: the frames of a batch step through their stripes together.

Key regularity (the paper's counter logic): for a stripe starting at row s*r,
round((s*r + i)/r) - s = round(i/r) and floor((s*r + i)/r) - s = 0 for
0 <= i < r, so the per-stripe scatter pattern and interpolation fractions are
static, independent of the stripe index; they are built once per call.

Index rules are JAX's: the GC scatter wraps a negative z bin once and drops
what is still outside the grid; the TI gathers wrap, then clamp. The z
coordinate is ``px / rs`` divided as the whole-image reference divides it
(the JAX module multiplies by ``1 / rs``), so a pixel bins as it does there
on every input. The ``"streaming"`` backend of
:class:`repro_torch.plan.BGPlan` runs this module: plain tensor operations
on the plan's device, as ``jnp`` runs it in the JAX package. It is fp32
only and not temporal, as there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bilateral_grid import (
    BGConfig,
    _divide,
    _round_half_up,
    _wrap_negative,
    conv3_axis,
    gaussian_taps,
    grid_shape,
    quantize_intensity,
)

__all__ = ["bilateral_grid_filter_streaming"]


def _trilerp_weights(frac: torch.Tensor):
    """(w0, w1) = (1-frac, frac): standard trilinear corner weights.

    Eq. (5) as printed assigns corner (i,j,k) weight |p - floor(p) - (i,j,k)|,
    which is the weight of the *opposite* corner; the standard form is used
    here, as in the JAX package.
    """
    return 1.0 - frac, frac


def bilateral_grid_filter_streaming(
    image,
    cfg: BGConfig | None = None,
    quantize_output: bool = True,
    sharded: bool = False,
    mesh=None,
    *,
    plan=None,
    device=None,
) -> torch.Tensor:
    """Stripe-streaming BG; numerically equivalent to bilateral_grid_filter.

    Accepts a single (h, w) frame or a (b, h, w) batch. Preferred form: pass
    a :class:`repro_torch.plan.BGPlan` with ``backend="streaming"`` via
    ``plan=``; otherwise one is built from ``cfg`` on ``device`` (the CUDA
    card unless ``device="cpu"``). Legacy ``sharded=True`` splits the batch
    axis over ``mesh`` (default: every card, when the caller wants the card
    and more than one is visible; ``repro_torch.sharding``), the same
    collective-free data parallelism as the fused routes; a ``mesh``
    without ``sharded=True`` is ignored, as in the JAX package.
    """
    from repro_torch.plan import BGPlan

    if plan is None:
        if cfg is None:
            raise TypeError("bilateral_grid_filter_streaming needs cfg= or plan=")
        if sharded and mesh is None:
            from repro_torch.sharding.bg_shard import _service_mesh

            mesh = _service_mesh(None, device)
        plan = BGPlan(cfg=cfg, backend="streaming", quantize_output=quantize_output, device=device,
                      mesh=mesh if sharded else None)
    return plan(image)


def _streaming_batch(frames: torch.Tensor, cfg: BGConfig, quantize_output: bool) -> torch.Tensor:
    """The stripe pipeline on (b, h, w) float32 frames on their device."""
    b, h, w = frames.shape
    dev = frames.device
    r = cfg.r
    _, gy, gz = grid_shape(h, w, cfg)
    n_stripes = -(-h // r)  # ceil
    hp = n_stripes * r
    taps = gaussian_taps(cfg).tolist()
    rs = cfg.range_scale

    # pad rows to a whole number of stripes (+ 2 epilogue stripes); padded
    # rows are masked out of GC
    pad = hp + 2 * r - h
    stripes = torch.nn.functional.pad(frames, (0, 0, 0, pad)).reshape(b, n_stripes + 2, r, w)
    masks = torch.nn.functional.pad(
        torch.ones((h, w), dtype=torch.float32, device=dev), (0, 0, 0, pad)
    ).reshape(n_stripes + 2, r, w)

    # --- static per-stripe index patterns (the paper's counters/LUT L2) ---
    i_local = np.arange(r)
    iy = np.arange(w)
    xg_local = torch.from_numpy((2 * i_local + r) // (2 * r)).to(dev)[None, :, None]  # round(i/r)
    xf_local = torch.from_numpy((i_local / r).astype(np.float32)).to(dev)
    yg = torch.from_numpy((2 * iy + r) // (2 * r)).to(dev)[None, None, :]  # GC round(iy/r)
    y0 = torch.from_numpy(iy // r).to(dev)  # TI floor
    yf = torch.from_numpy((iy / r - iy // r).astype(np.float32)).to(dev)
    bidx = torch.arange(b, device=dev)[:, None, None]
    y0b = y0[None, None, :]
    wx0, wx1 = _trilerp_weights(xf_local[:, None])  # (r, 1)
    wy0, wy1 = _trilerp_weights(yf[None, :])  # (1, w)

    def gc_stripe(px, msk):
        """Scatter (b, r, w) stripes into contributions for planes (s, s+1):
        (b, 2, gy, gz, 2), the x-plane offset from the stripe index second,
        (count, sum) last. Bins outside the grid are dropped, as JAX's
        scatter drops them."""
        zg = _wrap_negative(_round_half_up(_divide(px, rs)).long(), gz)
        keep = msk * ((zg >= 0) & (zg < gz)).to(torch.float32)
        vals = torch.stack([keep, px * keep], dim=-1)
        out = torch.zeros((b, 2, gy, gz, 2), dtype=torch.float32, device=dev)
        return out.index_put_(
            (bidx, xg_local.expand(b, r, w), yg.expand(b, r, w), zg.clamp(0, gz - 1)),
            vals, accumulate=True,
        )

    def blur_plane(r2, r1, r0):
        """3x3x3 blur of the middle raw plane given (prev, mid, next) planes."""
        mix = taps[0] * r2 + taps[1] * r1 + taps[2] * r0  # x-axis conv
        mix = conv3_axis(mix, taps, 1)  # y axis
        return conv3_axis(mix, taps, 2)  # z axis; (b, gy, gz, 2) homogeneous

    def divide(v):
        return torch.where(
            v[..., 0] > 1e-12, v[..., 1] / torch.clamp(v[..., 0], min=1e-12),
            torch.zeros_like(v[..., 1]),
        )

    def ti_stripe(px, b_lo, b_hi):
        """TI for (b, r, w) stripes given blurred planes floor(x) and
        floor(x)+1. In 'paper' mode b_* are normalized scalars (b, gy, gz);
        in 'classic' mode they are homogeneous (b, gy, gz, 2) and division
        happens per pixel."""
        fz = _divide(px, rs)
        z0 = torch.floor(fz).long()
        zf = fz - z0
        wz0, wz1 = _trilerp_weights(zf)
        classic = b_lo.dim() == 4

        def interp(plane):
            acc = torch.zeros(px.shape + plane.shape[3:], dtype=torch.float32, device=dev)
            for dj, wyj in ((0, wy0), (1, wy1)):
                yi = (y0b + dj).clamp(0, gy - 1)
                for dk, wzk in ((0, wz0), (1, wz1)):
                    c = plane[bidx, yi, _wrap_negative(z0 + dk, gz).clamp(0, gz - 1)]
                    wgt = wyj * wzk
                    acc = acc + (wgt[..., None] if classic else wgt) * c
            return acc

        lo = interp(b_lo)
        hi = interp(b_hi)
        if classic:  # homogeneous lerp, then divide
            return divide(wx0[..., None] * lo + wx1[..., None] * hi)
        return wx0 * lo + wx1 * hi

    paper = cfg.normalize_mode == "paper"
    zero_plane = torch.zeros((b, gy, gz, 2), dtype=torch.float32, device=dev)
    zero_stripe = torch.zeros((b, r, w), dtype=torch.float32, device=dev)
    R2 = R1 = Apart = zero_plane
    B1 = zero_plane[..., 0] if paper else zero_plane
    S2 = S1 = zero_stripe
    outs = []
    for s in range(n_stripes + 2):  # n_stripes real stripes + 2 epilogue zero stripes
        px = stripes[:, s]
        contrib = gc_stripe(px, masks[s])
        R0 = Apart + contrib[:, 0]  # raw plane s complete
        blurred = blur_plane(R2, R1, R0)  # blurred plane s-1
        Bnew = divide(blurred) if paper else blurred
        outs.append(ti_stripe(S2, B1, Bnew))  # TI of stripe s-2 (planes s-2, s-1)
        R2, R1, Apart, B1, S2, S1 = R1, R0, contrib[:, 1], Bnew, S1, px

    out = torch.stack(outs[2:], dim=1).reshape(b, hp, w)[:, :h]
    if quantize_output:
        out = quantize_intensity(out, cfg)
    return out
