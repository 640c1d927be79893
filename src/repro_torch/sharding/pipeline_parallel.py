"""GPipe-style pipeline parallelism over a dedicated mesh axis: the port of
the JAX package's ``repro/sharding/pipeline_parallel.py``.

Each rank of the ``pipe`` axis holds one stage's slice of the stacked
parameters; microbatches stream through with the classic
``n_micro + n_stages - 1``-step schedule, each step's output sent to the
next stage (``dist.batch_isend_irecv``: JAX's ``ppermute``). Bubble fraction
= (P-1)/(m+P-1). At the end the last stage's outputs go to every stage as
JAX's masked ``psum`` does: an ``all_reduce(SUM)`` of a tensor that is zero
everywhere but the last stage, so the arithmetic stays exact.

At production scale this composes with the (pod, data, model) mesh by
mapping ``pod`` (or a factor of ``data``) to ``pipe``; it is exercised on
CPU ``gloo`` meshes in ``tests/test_torch_lm_sharding.py``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.model import tree_map

from .compat import shard_map
from .partitioning import PartitionSpec as P
from .ring_attention import _ring_shift

__all__ = ["gpipe"]


def gpipe(stage_fn: Callable, stage_params, microbatches, mesh, axis: str = "pipe"):
    """Run ``y = stage_{P-1}(...stage_0(x))`` over microbatches, pipelined.

    ``stage_fn(params_one_stage, x) -> y``, same shape as ``x``.
    ``stage_params``: a tensor or a dict tree of them with a leading stage
    axis of size ``P = mesh.shape[axis]``. ``microbatches``: ``(n_micro,
    mb, ...)`` (replicated input). Returns ``(n_micro, mb, ...)`` outputs
    (a replicated DTensor)."""
    n_stages = mesh.shape[mesh.mesh_dim_names.index(axis)]
    n_micro = microbatches.shape[0]

    def local(params, xs):
        # params: leading axis 1 (this stage) -> squeeze
        params = tree_map(lambda p: p[0], params) if isinstance(params, dict) else params[0]
        idx = mesh.get_local_rank(axis)
        total = n_micro + n_stages - 1
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(total):
            # stage 0 ingests microbatch t while it exists
            inp = xs[min(t, n_micro - 1)] if idx == 0 else buf
            y = stage_fn(params, inp)
            # the last stage finishes microbatch t-(P-1)
            done = t - (n_stages - 1)
            if idx == n_stages - 1 and done >= 0:
                outs[done] = y
            (buf,) = _ring_shift((y,), mesh, axis)
        # broadcast the last stage's outputs to every stage
        if idx != n_stages - 1:
            outs = torch.zeros_like(outs)
        if n_stages > 1:
            dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
        return outs

    spec_params = tree_map(lambda _: P(axis), stage_params) if isinstance(stage_params, dict) else P(axis)
    fn = shard_map(local, mesh=mesh, in_specs=(spec_params, P()), out_specs=P())
    return fn(stage_params, microbatches)
