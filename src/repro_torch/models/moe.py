"""Mixture-of-experts FFN with shared experts (qwen2-moe / llama4 style), and
the dense FFN: the port of the JAX package's ``repro/models/moe.py``,
forward only.

Two dispatch backends:
  * "einsum" — GShard-style capacity-factor dispatch/combine one-hot
               einsums (the baseline; tokens past an expert's capacity are
               dropped).
  * "ragged" — dropless sorted dispatch; JAX's ``jax.lax.ragged_dot``
               becomes a loop over each group's experts with a matmul on
               each expert's rows.

Two details keep the JAX package's choices: the router's top-k breaks ties
to the lower expert index (``jax.lax.top_k``; here a stable descending
sort), and a one-hot of an index past its range is a zero row
(``jax.nn.one_hot``; here a comparison with ``arange``), which is how the
einsum dispatch drops a token past capacity.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoESpec

from repro_torch.sharding.partitioning import logical_constraint

from .layers import dense, dtype_of, gelu, init_dense, mesh_like, normal, on_local_shards

__all__ = ["init_moe", "moe_ffn", "init_ffn", "ffn_apply"]


# ------------------------------------------------------------- dense FFN
def init_ffn(gen, d_model: int, d_ff: int, kind: str, dtype=torch.float32, lead=(), device=None):
    kw = dict(dtype=dtype, lead=lead, device=device)
    if kind in ("swiglu", "geglu"):
        return {
            "gate": init_dense(gen, d_model, d_ff, **kw),
            "up": init_dense(gen, d_model, d_ff, **kw),
            "down": init_dense(gen, d_ff, d_model, **kw),
        }
    return {"up": init_dense(gen, d_model, d_ff, **kw), "down": init_dense(gen, d_ff, d_model, **kw)}


def ffn_apply(params, x, kind: str, act_dtype):
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else gelu
        h = act(dense(params["gate"], x, act_dtype)) * dense(params["up"], x, act_dtype)
    else:
        h = gelu(dense(params["up"], x, act_dtype))
    h = logical_constraint(h, "batch", "seq", "mlp")
    return logical_constraint(dense(params["down"], h, act_dtype), "batch", "seq", "embed")


# ------------------------------------------------------------------ MoE
def init_moe(gen, cfg: ModelConfig, spec: MoESpec, lead=(), device=None):
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    E, F_ = spec.num_experts, spec.d_ff_expert
    p = {
        "router": init_dense(gen, d, E, dtype=torch.float32, lead=lead, device=device),
        "w_gate": normal(gen, (*lead, E, d, F_), 1.0 / math.sqrt(d), dt, device),
        "w_up": normal(gen, (*lead, E, d, F_), 1.0 / math.sqrt(d), dt, device),
        "w_down": normal(gen, (*lead, E, F_, d), 1.0 / math.sqrt(F_), dt, device),
    }
    if spec.num_shared:
        p["shared"] = init_ffn(gen, d, spec.d_ff_shared * spec.num_shared, "swiglu", dt, lead, device)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row for an index outside [0, n)."""
    return (idx.long()[..., None] == mesh_like(torch.arange(n, device=idx.device), idx)).to(dtype)


def _router(params, x, spec: MoESpec):
    """Returns (gates (..., K), idx (..., K), probs (..., E)) in fp32."""
    logits = dense(params["router"], x.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    # on a mesh, each rank sorts its rows' local shards (torch 2.11's DTensor
    # cannot differentiate the sort)
    vals, order = on_local_shards(lambda p: tuple(torch.sort(p, dim=-1, descending=True, stable=True)),
                                  [probs], [(0, None)], [(0, None), (0, None)])
    gates, idx = vals[..., : spec.top_k], order[..., : spec.top_k]
    if spec.norm_topk:
        gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _aux_loss(probs, idx, spec: MoESpec):
    """Switch-style load-balance loss: E * mean(frac_tokens) . mean(probs)."""
    E = spec.num_experts
    onehot = _one_hot(idx[..., 0], E, torch.float32)  # top-1 assignment
    frac_tokens = torch.mean(onehot, dim=tuple(range(onehot.ndim - 1)))
    mean_probs = torch.mean(probs, dim=tuple(range(probs.ndim - 1)))
    return E * torch.sum(frac_tokens * mean_probs) * spec.router_aux_weight


def _expert_axes(spec: MoESpec):
    """Logical sharding of the token-in-expert tensors by EP/TP mode: the TP
    axis carries either the expert axis (EP) or the expert hidden dim (TP),
    never both."""
    if spec.sharding == "ep":
        return "expert", None
    return None, "expert_mlp"


def _moe_einsum(params, x, spec: MoESpec, act):
    """GShard dispatch: x (B,S,d) -> (B,S,d), aux loss, in groups of
    ``group_size`` tokens so the (G, E, C) one-hots stay bounded."""
    B, S, d = x.shape
    E, K = spec.num_experts, spec.top_k
    gates, idx, probs = _router(params, x, spec)
    aux = _aux_loss(probs, idx, spec)

    G = min(spec.group_size, S)
    NG = (B * S) // G
    xg = x.reshape(NG, G, d)
    idx_g = idx.reshape(NG, G, K)
    gates_g = gates.reshape(NG, G, K)
    C = max(4, int(G * K * spec.capacity_factor / E))

    # position of each (token, k) routing choice within its expert's capacity
    oh = _one_hot(idx_g, E, act)  # (NG,G,K,E)
    flat = oh.reshape(NG, G * K, E)
    pos = torch.cumsum(flat.to(torch.float32), dim=1) - 1.0
    pos = (pos * flat).reshape(NG, G, K, E).sum(-1)  # (NG,G,K) slot per choice
    keep = (pos < C).to(act)
    slot_oh = _one_hot(pos.to(torch.int32), C, act)  # zero row past capacity
    disp = torch.einsum("gske,gskc->gsec", oh * keep[..., None], slot_oh)
    comb = torch.einsum("gske,gskc,gsk->gsec", oh, slot_oh, gates_g.to(act) * keep)

    eax, fax = _expert_axes(spec)
    disp = logical_constraint(disp, "batch", None, eax, None)
    # on a mesh, on each rank's groups and experts (as the combine below):
    # DTensor's backward of this product flattens the expert axis, which
    # it cannot do once the axis is sharded unevenly (60 experts on 16)
    xin = on_local_shards(functools.partial(torch.einsum, "gsec,gsd->egcd"), [disp, xg.to(act)],
                          [(0, 2), (0, None)], (1, 0))
    xin = logical_constraint(xin, eax, "batch", None, None)
    h = F.silu(torch.einsum("egcd,edf->egcf", xin, params["w_gate"].to(act)))
    h = h * torch.einsum("egcd,edf->egcf", xin, params["w_up"].to(act))
    h = logical_constraint(h, eax, "batch", None, fax)
    out = torch.einsum("egcf,efd->egcd", h, params["w_down"].to(act))
    # on a mesh, on each rank's groups with every expert: the backward of
    # this product unflattens the contracted (e, c) axis, which DTensor
    # cannot do once it is sharded
    y = on_local_shards(functools.partial(torch.einsum, "gsec,egcd->gsd"), [comb, out], [(0, None), (1, None)],
                        (0, None))
    return y.reshape(B, S, d), aux


def _ragged_dot(toks: torch.Tensor, w: torch.Tensor, sizes) -> torch.Tensor:
    """``jax.lax.ragged_dot``: rows ``[o_e, o_e + sizes[e])`` of ``toks``
    times ``w[e]``, for experts in order."""
    out = torch.zeros((toks.shape[0], w.shape[-1]), dtype=toks.dtype, device=toks.device)
    o = 0
    for e, n in enumerate(sizes):
        if n:
            out[o:o + n] = toks[o:o + n] @ w[e]
        o += n
    return out


def _moe_ragged(params, x, spec: MoESpec, act):
    """Dropless sorted dispatch + grouped GEMMs, group-local: tokens are
    sorted by expert within fixed-size groups (a stable sort, as
    ``jnp.argsort``), each group runs three grouped products."""
    B, S, d = x.shape
    E, K = spec.num_experts, spec.top_k
    gates, idx, probs = _router(params, x, spec)
    aux = _aux_loss(probs, idx, spec)

    G = min(spec.group_size, S)
    NG = (B * S) // G
    xg = x.reshape(NG, G, d).to(act)
    xg = logical_constraint(xg, "batch", None, None)
    idx_g = idx.reshape(NG, G * K)
    gates_g = gates.reshape(NG, G, K).to(act)

    order = torch.argsort(idx_g, dim=-1, stable=True)  # choices grouped by expert
    tok_of_choice = torch.div(order, K, rounding_mode="floor")
    sorted_tokens = torch.gather(xg, 1, tok_of_choice[..., None].expand(-1, -1, d))
    group_sizes = F.one_hot(idx_g, E).sum(1).tolist()  # (NG, E) on the host

    wg, wu, wd = (params[n].to(act) for n in ("w_gate", "w_up", "w_down"))
    out_sorted = torch.stack([
        _ragged_dot(F.silu(_ragged_dot(toks, wg, gs)) * _ragged_dot(toks, wu, gs), wd, gs)
        for toks, gs in zip(sorted_tokens, group_sizes)
    ])
    inv = torch.argsort(order, dim=-1)
    out = torch.gather(out_sorted, 1, inv[..., None].expand(-1, -1, d)).reshape(NG, G, K, d)
    y = torch.einsum("gskd,gsk->gsd", out, gates_g).reshape(B, S, d)
    return y, aux


def moe_ffn(params, x, cfg: ModelConfig, spec: MoESpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed experts + optional shared experts. Returns (y, aux_loss)."""
    act = dtype_of(cfg.act_dtype)
    if spec.dispatch == "ragged":
        # replicated on a mesh: the sorted dispatch sizes its groups on the
        # host and loops over experts, which DTensor cannot shard, and its
        # aux loss is a mean over every token
        names = ("w_gate", "w_up", "w_down")
        y, aux = on_local_shards(
            lambda x, r, wg, wu, wd: _moe_ragged({"router": {"kernel": r}, **dict(zip(names, (wg, wu, wd)))},
                                                 x, spec, act),
            [x, params["router"]["kernel"], *(params[n] for n in names)], [(None, None)] * 5, [(None, None)] * 2)
    else:
        y, aux = _moe_einsum(params, x, spec, act)
    if spec.num_shared:
        y = y + ffn_apply(params["shared"], x, "swiglu", act)
    return logical_constraint(y, "batch", "seq", "embed"), aux
