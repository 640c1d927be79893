"""The counting cases of ``tests/test_torch_dryrun.py`` that need a process
group, run in a process of their own (a group is process-wide and must not
outlive its test in an xdist worker):

    python tests/torch_dryrun_cases.py <out.json>

Writes one JSON object of what the tests check. Imports the port only (no
JAX). Every group here is torch's ``fake`` group (rank 0 of N, on ``meta``
tensors), destroyed before the next case starts.
"""
import dataclasses
import json
import math
import os
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def _fake(world):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def ring_model() -> dict:
    """Each collective kind once on an 8-rank group, under ``CostMode``."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.launch.hlo_cost import CostMode

    _fake(8)
    try:
        group = dist.group.WORLD
        t = torch.empty(64, 32, device="meta")  # 8 KiB
        out = {}
        for kind, fn in [("all-reduce", lambda: funcol.all_reduce(t, "sum", group)),
                         ("all-gather", lambda: funcol.all_gather_tensor(t, 0, group)),
                         ("reduce-scatter", lambda: funcol.reduce_scatter_tensor(t, "sum", 0, group)),
                         ("c10d all-reduce", lambda: dist.all_reduce(t.clone()))]:
            with CostMode() as mode:
                fn()
            out[kind] = mode.cost().collectives
        return out
    finally:
        dist.destroy_process_group()


def dtensor_product() -> dict:
    """A (256, 4096) @ (4096, 4096) product, rows over ``data`` and columns
    over ``model`` of a 16x16 mesh: only rank 0's local product counts."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.hlo_cost import analyze_step
    from repro_torch.sharding.compat import dtensor_api

    DTensor, Shard, Replicate = dtensor_api()[:3]
    _fake(256)
    try:
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        a = DTensor.from_local(torch.empty(16, 4096, device="meta"), mesh, [Shard(0), Replicate()],
                               run_check=False, shape=torch.Size((256, 4096)), stride=(4096, 1))
        b = DTensor.from_local(torch.empty(4096, 256, device="meta"), mesh, [Replicate(), Shard(1)],
                               run_check=False, shape=torch.Size((4096, 4096)), stride=(4096, 1))
        return {"flops": analyze_step(torch.matmul, a, b).flops}
    finally:
        dist.destroy_process_group()


def _local_numel(shape, spec, sizes) -> int:
    """Rank 0's shard of ``shape`` under ``spec``: ``torch.chunk``'s first
    piece along each sharded dimension, by hand."""
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        ways = 1
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            ways *= sizes[a]
        n *= math.ceil(d / ways)
    return n


def mini_cell() -> dict:
    """The port's form of the JAX package's mini dry-run cell: smoke
    gemma2-9b with ``grad_accum=2`` on a (2, 4) mesh, its argument bytes
    counted by hand; hubert-xlarge (every sharded dim divides 2 and 4) on
    the mesh and at world 1; a prefill and a decode cell; the refusal
    beside a live group."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.dryrun import _shard_tree, dry_run
    from repro_torch.launch.specs import batch_logical_axes, input_specs
    from repro_torch.models import init_params, param_logical_axes, tree_leaves
    from repro_torch.sharding.partitioning import DEFAULT_RULES, MeshShape

    mesh = MeshShape(("data", "model"), (2, 4))
    shape = ShapeSpec("mini", 32, 8, "train")
    cfg = dataclasses.replace(get_smoke_config("gemma2-9b"), grad_accum=2)
    out = {"gemma2-9b": dry_run(cfg, shape, mesh), "group_after": dist.is_initialized()}
    pshape = init_params(0, cfg, device="meta")
    psh = tree_leaves(_shard_tree(param_logical_axes(cfg), mesh, DEFAULT_RULES, pshape))
    batch = input_specs(cfg, shape)
    bsh = tree_leaves(_shard_tree(batch_logical_axes(cfg, shape), mesh, DEFAULT_RULES, batch))
    p_bytes = sum(_local_numel(t.shape, s.spec, mesh.shape) * 4 for t, s in zip(tree_leaves(pshape), psh))
    b_bytes = sum(_local_numel(t.shape, s.spec, mesh.shape) * t.element_size()
                  for t, s in zip(tree_leaves(batch), bsh))
    out["gemma2-9b_argument_bytes_by_hand"] = 3 * p_bytes + 4 + b_bytes  # params, m, v (fp32), the step
    hub = dataclasses.replace(get_smoke_config("hubert-xlarge"), grad_accum=2)
    out["hubert-xlarge"] = dry_run(hub, shape, mesh)
    out["hubert-xlarge_world1"] = dry_run(hub, shape, MeshShape(("data", "model"), (1, 1)))
    yi = get_smoke_config("yi-6b")
    out["yi-6b_prefill"] = dry_run(yi, ShapeSpec("p", 16, 8, "prefill"), mesh)
    out["yi-6b_decode"] = dry_run(yi, ShapeSpec("d", 16, 8, "decode"), mesh)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        dry_run(yi, ShapeSpec("d", 16, 8, "decode"), mesh)
        out["refused"] = None
    except RuntimeError as e:
        out["refused"] = str(e)
    finally:
        dist.destroy_process_group()
    return out


def production_cell() -> dict:
    """One production cell through ``run_cell`` on the 256-rank mesh."""
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell("qwen2-moe-a2.7b", "decode_32k", False)
    return {"record": rec, "group_after": dist.is_initialized()}


if __name__ == "__main__":
    warnings.filterwarnings("ignore")
    import logging

    logging.disable(logging.WARNING)
    torch.set_num_threads(1)
    results = {"ring": ring_model(), "dtensor": dtensor_product(), "mini": mini_cell(),
               "production": production_cell()}
    with open(sys.argv[1], "w") as f:
        json.dump(results, f, default=str)
