"""Ring attention: sequence-parallel exact attention over a mesh axis, the
port of the JAX package's ``repro/sharding/ring_attention.py``.

For long-context prefill the residual stream can be sharded along the
sequence (``SP_RULES``); attention then needs every (q, k) pair across
shards. Each rank keeps its queries and accumulates their online-softmax
state while K, V and the key positions travel around the ring of the
``axis`` group (``dist.batch_isend_irecv`` to the next rank, from the
previous one: JAX's ``ppermute``). A ring of one sends nothing.

This is the counterpart of ``models.attention._sdpa_blocked`` (the same
online-softmax merge, over a mesh axis instead of a loop), run through the
port's ``shard_map``; exactness against ``_sdpa_plain`` is held in
``tests/test_torch_lm_sharding.py``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import AttnSpec
from repro_torch.models.attention import NEG_INF, _mask_logits, _q_scale

from .compat import shard_map
from .partitioning import PartitionSpec as P

__all__ = ["ring_attention"]


def _ring_shift(tensors, mesh, axis: str):
    """Each tensor sent to the next rank of ``mesh``'s ``axis`` group and
    replaced by the previous rank's (JAX's ``ppermute`` with ``i -> i+1``)."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if n == 1:
        return tensors
    i = mesh.get_local_rank(axis)
    nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t, nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prv, group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def ring_attention(q, k, v, positions, spec: AttnSpec, mesh, axis: str = "data", softcap: float = 0.0):
    """q (B,S,H,D), k/v (B,S,KV,D), positions (B,S); S sharded over ``axis``
    of ``mesh`` (a ``DeviceMesh``). Plain inputs are the full tensors on
    every rank; DTensors are redistributed.

    Returns (B,S,H,D), a DTensor sharded the same way. Exact
    (online-softmax merge)."""
    n = mesh.shape[mesh.mesh_dim_names.index(axis)]

    def local(q, k, v, pos):
        B, Sl, H, D = q.shape
        KV = k.shape[2]
        G = H // KV
        qg = (q * _q_scale(q)).reshape(B, Sl, KV, G, D)
        qpos = pos

        m = torch.full((B, KV, G, Sl), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, Sl), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, Sl, D), dtype=torch.float32, device=q.device)
        kc, vc, kpos = k, v, pos

        for _ in range(n):  # the ring walk
            logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).to(torch.float32)
            if softcap > 0.0:
                logits = softcap * torch.tanh(logits / softcap)
            logits = _mask_logits(logits, qpos[:, None, None, :], kpos[:, None, None, :], spec)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc.to(torch.float32))
            m = m_new
            kc, vc, kpos = _ring_shift((kc, vc, kpos), mesh, axis)

        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return torch.movedim(out, 3, 1).reshape(B, Sl, H, D).to(q.dtype)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis, None, None), P(None, axis, None, None), P(None, axis, None, None), P(None, axis)),
        out_specs=P(None, axis, None, None),
    )
    return fn(q, k, v, positions)
