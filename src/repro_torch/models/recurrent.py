"""Recurrent blocks: Griffin RG-LRU (recurrentgemma) and xLSTM (mLSTM/sLSTM):
the port of the JAX package's ``repro/models/recurrent.py``.

All three have train/prefill and an O(1)-state decode step. The RG-LRU
recurrence runs as a sequential loop over time where JAX runs
``jax.lax.associative_scan``: the same products, summed in another order,
so the two agree to a tolerance, not bit for bit. mLSTM keeps JAX's
quadratic parallel form and its chunkwise form; sLSTM is a loop over time
in both packages.

State dicts (per layer):
  rglru: {"h": (B,W), "conv": (B,K-1,W)}
  mlstm: {"C": (B,H,D,D), "n": (B,H,D), "m": (B,H), "conv": (B,K-1,W)}
  slstm: {"c","n","h","m": (B,W)}
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.compat import is_dtensor
from repro_torch.sharding.partitioning import logical_constraint

from .layers import dense, dtype_of, gelu, init_dense, merge_heads, mesh_like, normal, on_local_shards, splittable

__all__ = [
    "init_rglru_block",
    "rglru_block",
    "init_rglru_state",
    "init_mlstm_block",
    "mlstm_block",
    "init_mlstm_state",
    "init_slstm_block",
    "slstm_block",
    "init_slstm_state",
]

_LRU_C = 8.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor ``-softplus(-x)``, ``jax.nn.log_sigmoid``'s
    own formula, since DTensor has no sharding strategy for
    ``aten.log_sigmoid_backward``."""
    if is_dtensor(x):
        return -_softplus(-x)
    return F.logsigmoid(x)


# ============================================================ causal conv1d
def _causal_conv(x, kernel, conv_state=None):
    """x (B,S,W), kernel (K,W) depthwise causal conv.

    conv_state (B,K-1,W) holds the trailing inputs from the previous segment;
    returns (y, new_conv_state)."""
    K = kernel.shape[0]
    B, S, W = x.shape
    if conv_state is None:
        conv_state = mesh_like(torch.zeros((B, K - 1, W), dtype=x.dtype, device=x.device), x)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xp[:, i:i + S] * kernel[K - 1 - i]
    new_state = xp[:, S:][:, -(K - 1):] if K > 1 else conv_state
    return y, new_state


def _conv_kernel(width: int, w: int, dt, lead, device):
    kernel = torch.zeros((*lead, width, w), dtype=dt, device=device)
    kernel[..., -1, :] = 1.0
    return kernel


# ================================================================== RG-LRU
def init_rglru_block(gen, cfg: ModelConfig, lead=(), device=None):
    d, w = cfg.d_model, cfg.rnn_width
    dt = dtype_of(cfg.param_dtype)
    kw = dict(dtype=dt, lead=lead, device=device)
    p = {
        "in_proj": init_dense(gen, d, w, **kw),
        "gate_proj": init_dense(gen, d, w, **kw),
        "conv": {"kernel": _conv_kernel(cfg.conv1d_width, w, dt, lead, device)},
        "lru_a": init_dense(gen, w, w, **kw),
        "lru_x": init_dense(gen, w, w, **kw),
    }
    # Lambda init so a = exp(-c*softplus(L)) is spread in [0.9, 0.999]
    u = torch.rand((*lead, w), generator=gen, dtype=torch.float32, device=device) * 0.099 + 0.9
    p["lambda"] = torch.log(torch.expm1(-torch.log(u) / _LRU_C)).to(dt)
    p["out_proj"] = init_dense(gen, w, d, **kw)
    return p


def _rglru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over the time axis, one step at a time."""
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0.to(b.dtype)
    out = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru_block(params, x, cfg: ModelConfig, mode="train", state: Optional[dict] = None):
    """Griffin recurrent block: (gate ∥ conv1d→RG-LRU) -> multiply -> out."""
    act = dtype_of(cfg.act_dtype)
    gate = gelu(dense(params["gate_proj"], x, act))
    u = dense(params["in_proj"], x, act)
    u = logical_constraint(u, "batch", "seq", "rnn")

    conv_state = state["conv"] if state is not None else None
    u, new_conv = _causal_conv(u, params["conv"]["kernel"].to(act), conv_state)

    # gates in fp32 for stability
    u32 = u.to(torch.float32)
    r = torch.sigmoid(dense(params["lru_a"], u32))
    i = torch.sigmoid(dense(params["lru_x"], u32))
    log_a = -_LRU_C * _softplus(params["lambda"].to(torch.float32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u32)

    if mode == "decode":
        if state is None or x.shape[1] != 1:
            raise ValueError("decode takes one token per row and a state")
        h = a[:, 0] * state["h"].to(torch.float32) + b[:, 0]
        h_seq = h[:, None]
        new_state = {"h": h, "conv": new_conv}
    else:
        h_seq = _rglru_scan(a, b, state["h"] if state is not None else None)
        new_state = {"h": h_seq[:, -1], "conv": new_conv} if mode == "prefill" else None

    y = h_seq.to(act) * gate
    y = dense(params["out_proj"], y, act)
    return logical_constraint(y, "batch", "seq", "embed"), new_state


def init_rglru_state(cfg: ModelConfig, batch: int, lead=(), device=None):
    w = cfg.rnn_width
    return {
        "h": torch.zeros((*lead, batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv1d_width - 1, w),
                            dtype=dtype_of(cfg.act_dtype), device=device),
    }


# =================================================================== mLSTM
def init_mlstm_block(gen, cfg: ModelConfig, lead=(), device=None):
    d, w = cfg.d_model, cfg.rnn_width
    dt = dtype_of(cfg.param_dtype)
    kw = dict(dtype=dt, lead=lead, device=device)
    return {
        "up_proj": init_dense(gen, d, 2 * w, **kw),
        "conv": {"kernel": _conv_kernel(cfg.conv1d_width, w, dt, lead, device)},
        "q": init_dense(gen, w, w, **kw),
        "k": init_dense(gen, w, w, **kw),
        "v": init_dense(gen, w, w, **kw),
        "ifgate": init_dense(gen, w, 2 * cfg.n_heads, **kw),
        "down_proj": init_dense(gen, w, d, **kw),
    }


def _causal_mask(S: int, device) -> torch.Tensor:
    t = torch.arange(S, device=device)
    return (t[None, :] <= t[:, None])[None, :, :, None]


def _mlstm_parallel(q, k, v, log_i, log_f):
    """Stabilized parallel form (B,S,H,D). Quadratic in S, causal."""
    B, S, H, D = q.shape
    cum_f = torch.cumsum(log_f, dim=1)  # (B,S,H)
    # D[t,s] = cum_f[t] - cum_f[s] + log_i[s] for s <= t
    dmat = cum_f[:, :, None, :] - cum_f[:, None, :, :] + log_i[:, None, :, :]
    dmat = torch.where(_causal_mask(S, q.device), dmat, -math.inf)
    m = torch.amax(dmat, dim=2, keepdim=True)  # (B,S,1,H)
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bqhd,bkhd->bqkh", q, k)  # k pre-scaled by 1/sqrt(D)
    wmat = scores * dexp
    num = torch.einsum("bqkh,bkhd->bqhd", wmat, v)
    den = torch.abs(torch.sum(wmat, dim=2))  # (B,S,H)
    den = torch.maximum(den, torch.exp(-m[:, :, 0, :]))
    return num / den[..., None]


# Sequences at least this long use the chunkwise form (the parallel form's
# S^2 gate matrix would not fit device memory at 32k+).
MLSTM_CHUNK_MIN_SEQ = 4096
MLSTM_CHUNK = 1024


def _mlstm_chunkwise(q, k, v, log_i, log_f, chunk: int = MLSTM_CHUNK):
    """Chunk-parallel mLSTM: intra-chunk parallel form + cross-chunk
    recurrent (C, n, m) state. Memory O(S*chunk) not O(S^2).

    Shapes: q/k/v (B,S,H,D), gates (B,S,H)."""
    B, S, H, D = q.shape
    if S % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {S}")
    mask = _causal_mask(chunk, q.device)
    C = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    m_prev = torch.full((B, H), -1e30, dtype=torch.float32, device=q.device)
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc, li, lf = q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], log_f[:, sl]
        ell = torch.cumsum(lf, dim=1)  # (B,chunk,H) local cumulative log f
        dmat = ell[:, :, None, :] - ell[:, None, :, :] + li[:, None, :, :]
        dmat = torch.where(mask, dmat, -math.inf)
        m_intra = torch.amax(dmat, dim=2)  # (B,chunk,H)
        b_inter = ell + m_prev[:, None, :]  # log weight of incoming state
        m_t = torch.maximum(m_intra, b_inter)

        scores = torch.einsum("bqhd,bkhd->bqkh", qc, kc)
        w = scores * torch.exp(dmat - m_t[:, :, None, :])
        num = torch.einsum("bqkh,bkhd->bqhd", w, vc)
        den = torch.sum(w, dim=2)
        inter_scale = torch.exp(b_inter - m_t)
        num = num + inter_scale[..., None] * torch.einsum("bhvk,bqhk->bqhv", C, qc)
        den = den + inter_scale * torch.einsum("bhk,bqhk->bqh", n, qc)
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None])

        # fold this chunk into the carried state
        ell_L = ell[:, -1, :]  # (B,H) total log f of the chunk
        d_state = ell_L[:, None, :] - ell + li  # weight of step s in new state
        m_state = torch.maximum(torch.amax(d_state, dim=1), ell_L + m_prev)
        wgt = torch.exp(d_state - m_state[:, None, :])
        carry_scale = torch.exp(ell_L + m_prev - m_state)
        C = carry_scale[..., None, None] * C + torch.einsum("bsh,bshv,bshk->bhvk", wgt, vc, kc)
        n = carry_scale[..., None] * n + torch.einsum("bsh,bshk->bhk", wgt, kc)
        m_prev = m_state
    return torch.cat(hs, dim=1), (C, n, m_prev)


def _mlstm_chunkwise_flat(q, k, v, log_i, log_f):
    h, (C, n, m) = _mlstm_chunkwise(q, k, v, log_i, log_f)
    return h, C, n, m


def mlstm_block(params, x, cfg: ModelConfig, mode="train", state: Optional[dict] = None):
    act = dtype_of(cfg.act_dtype)
    B, S, _ = x.shape
    H = cfg.n_heads
    w = cfg.rnn_width
    dh = w // H
    up = dense(params["up_proj"], x, act)
    xm, z = torch.chunk(up, 2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xm, params["conv"]["kernel"].to(act), conv_state)
    xc = F.silu(xc)

    def heads(t):
        return splittable(t, 2, H).reshape(B, S, H, dh).to(torch.float32)

    q = heads(dense(params["q"], xc))
    k = heads(dense(params["k"], xc)) / math.sqrt(dh)
    v = heads(dense(params["v"], xm))
    gates = splittable(dense(params["ifgate"], xc.to(torch.float32)), 2, 2).reshape(B, S, 2, H)
    log_i = gates[:, :, 0]
    log_f = _log_sigmoid(gates[:, :, 1])

    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("decode takes one token per row and a state")
        C, n, m = state["C"], state["n"], state["m"]
        li, lf = log_i[:, 0], log_f[:, 0]
        m_new = torch.maximum(lf + m, li)  # (B,H)
        fs = torch.exp(lf + m - m_new)[..., None]
        iS = torch.exp(li - m_new)[..., None]
        k0, v0, q0 = k[:, 0], v[:, 0], q[:, 0]
        C_new = fs[..., None] * C + iS[..., None] * (v0[..., :, None] * k0[..., None, :])
        n_new = fs * n + iS * k0
        num = torch.einsum("bhvk,bhk->bhv", C_new, q0)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q0)), torch.exp(-m_new))
        h = (num / den[..., None])[:, None]  # (B,1,H,dh)
        new_state = {"C": C_new, "n": n_new, "m": m_new}
    elif S >= MLSTM_CHUNK_MIN_SEQ and S % MLSTM_CHUNK == 0:
        # both forms are independent per row and head: on a mesh, each rank
        # runs them on its local shards (on_local_shards)
        h, C_new, n_new, m_new = on_local_shards(_mlstm_chunkwise_flat, [q, k, v, log_i, log_f],
                                                 [(0, 2)] * 5, [(0, 2), (0, 1), (0, 1), (0, 1)])
        new_state = {"C": C_new, "n": n_new, "m": m_new}
    else:
        h = on_local_shards(_mlstm_parallel, [q, k, v, log_i, log_f], [(0, 2)] * 5, (0, 2))
        new_state = None
        if mode == "prefill":
            # fold the whole prefix into the recurrent state for decoding
            cum_f = torch.cumsum(log_f, dim=1)
            rev = cum_f[:, -1:, :] - cum_f  # sum_{j>t} log f_j
            dt_ = rev + log_i  # weight of step t in final state (log)
            m_new = torch.amax(dt_, dim=1)  # (B,H)
            wgt = torch.exp(dt_ - m_new[:, None])
            new_state = {"C": torch.einsum("bsh,bshv,bshk->bhvk", wgt, v, k),
                         "n": torch.einsum("bsh,bshk->bhk", wgt, k), "m": m_new}

    y = merge_heads(h.to(act)) * F.silu(z)
    y = dense(params["down_proj"], y, act)
    y = logical_constraint(y, "batch", "seq", "embed")
    if mode == "train":
        return y, None
    return y, {**new_state, "conv": new_conv}


def init_mlstm_state(cfg: ModelConfig, batch: int, lead=(), device=None):
    H = cfg.n_heads
    dh = cfg.rnn_width // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((*lead, batch, H, dh, dh), **f32),
        "n": torch.zeros((*lead, batch, H, dh), **f32),
        "m": torch.full((*lead, batch, H), -1e30, **f32),
        "conv": torch.zeros((*lead, batch, cfg.conv1d_width - 1, cfg.rnn_width),
                            dtype=dtype_of(cfg.act_dtype), device=device),
    }


# =================================================================== sLSTM
def init_slstm_block(gen, cfg: ModelConfig, lead=(), device=None):
    """Recurrent state mixing is BLOCK-DIAGONAL per head (the xLSTM paper's
    structure): H blocks of (w/H, 4w/H) instead of a dense (w, 4w)."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    H = cfg.n_heads
    wh = w // H
    dt = dtype_of(cfg.param_dtype)
    kw = dict(dtype=dt, lead=lead, device=device)
    return {
        "in_proj": init_dense(gen, d, 4 * w, **kw),  # i,f,z,o pre-acts
        "rec_proj": {"kernel": normal(gen, (*lead, H, wh, 4 * wh), 1.0 / math.sqrt(wh), dt, device)},
        "out_proj": init_dense(gen, w, d, **kw),
    }


def _slstm_step(params, carry, xt):
    """One sLSTM step with exponential gating + stabilizer state m."""
    c, n, h, m = carry
    B = h.shape[0]
    rec_k = params["rec_proj"]["kernel"]
    H, wh = rec_k.shape[0], rec_k.shape[1]
    rec = torch.einsum("bhw,hwv->bhv", h.reshape(B, H, wh).to(rec_k.dtype), rec_k)
    # per-head (4, wh) chunks -> global (4w,) gate layout
    rec = rec.reshape(B, H, 4, wh).permute(0, 2, 1, 3).reshape(B, 4 * H * wh)
    pre = xt + rec.to(xt.dtype)  # (B, 4w)
    i_t, f_t, z_t, o_t = torch.chunk(pre, 4, dim=-1)
    log_i = i_t  # exp input gate (log-space value)
    log_f = _log_sigmoid(f_t)
    m_new = torch.maximum(log_f + m, log_i)
    ig = torch.exp(log_i - m_new)
    fg = torch.exp(log_f + m - m_new)
    c_new = fg * c + ig * torch.tanh(z_t)
    n_new = fg * n + ig
    h_new = torch.sigmoid(o_t) * (c_new / torch.clamp(n_new, min=1e-6))
    return (c_new, n_new, h_new, m_new), h_new


def slstm_block(params, x, cfg: ModelConfig, mode="train", state: Optional[dict] = None):
    act = dtype_of(cfg.act_dtype)
    B, S, _ = x.shape
    w = cfg.rnn_width or cfg.d_model
    pre = dense(params["in_proj"], x, act).to(torch.float32)  # (B,S,4w)

    if state is not None:
        carry = (state["c"], state["n"], state["h"], state["m"])
    else:
        z = torch.zeros((B, w), dtype=torch.float32, device=x.device)
        carry = (z, z, z, torch.full((B, w), -1e30, dtype=torch.float32, device=x.device))
    if mode == "decode" and S != 1:
        raise ValueError("decode takes one token per row")

    def scan(pre, rec_kernel, *carry):
        hs = []
        for t in range(S):
            carry, h = _slstm_step({"rec_proj": {"kernel": rec_kernel}}, carry, pre[:, t])
            hs.append(h)
        return (torch.stack(hs, dim=1), *carry)

    # the recurrence is independent per row: on a mesh, each rank scans its
    # rows' local shards with the whole recurrent kernel (on_local_shards)
    hs, *carry = on_local_shards(scan, [pre, params["rec_proj"]["kernel"], *carry],
                                 [(0, None), (None, None)] + [(0, None)] * 4, [(0, None)] * 5)
    y = dense(params["out_proj"], hs.to(act), act)
    y = logical_constraint(y, "batch", "seq", "embed")
    if mode == "train":
        return y, None
    c, n, h, m = carry
    return y, {"c": c, "n": n, "h": h, "m": m}


def init_slstm_state(cfg: ModelConfig, batch: int, lead=(), device=None):
    w = cfg.rnn_width or cfg.d_model
    z = torch.zeros((*lead, batch, w), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full((*lead, batch, w), -1e30, dtype=torch.float32, device=device)}
