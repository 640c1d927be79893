"""Multi-pod dry-run: count every (arch x shape x mesh) cell's step on meta
tensors, the port of the JAX package's ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k --out /tmp/d
    PYTHONPATH=src python -m repro_torch.launch.roofline --dir /tmp/d

JAX lowers and compiles each cell on 512 forced host devices. The port has
no compiler to ask: it runs the cell's step once, eagerly, as rank 0 of the
production mesh, on tensors that hold no data, and counts what runs:

* the mesh is a ``DeviceMesh`` of 256 (``16x16``) or 512 (``2x16x16``) CPU
  ranks over torch's ``fake`` process group (collectives return at once and
  move nothing), made by :func:`dry_run` and destroyed before it returns;
  it refuses to start where a process group exists already, since a group
  is process-wide;
* parameters, optimizer state, batch and caches are DTensors over ``meta``
  shards, laid out by :func:`_shard_tree`'s specs (the batch of a train
  step is given whole, on every rank, and cut to its shard inside the step,
  the port's train-step contract);
* the train step (``train/train_step.py``, donating as JAX's does), the
  prefill or the decode step runs under
  :class:`repro_torch.launch.hlo_cost.CostMode`, which gives rank 0's FLOPs,
  HBM bytes, collectives and allocated bytes; the roofline terms are
  :func:`repro_torch.launch.hlo_analysis.roofline_terms`' (H100 rates).

These tensors never touch a card, nor memory: a 110B-parameter cell runs in
the host's memory of its Python objects. This is how the dry-run works, not
a fallback; the same counting holds a step on the card against its
measured time in ``chip_smoke.py`` (phase ``dryrun_slice``).

A cell's record keeps the JAX package's keys. ``lower_s`` is the seconds to
build the mesh and lay the state out, ``compile_s`` the seconds of the
counted run. ``memory`` holds rank 0's ``argument_size_in_bytes`` (the
local shards of every input, the batch's as the step cuts it),
``output_size_in_bytes`` (the local bytes of the outputs' storages) and
``temp_size_in_bytes`` (the peak of the bytes the run allocated and still
held, outputs included); XLA's ``generated_code_size_in_bytes`` has no
counterpart. ``cost`` holds the counted ``flops`` and ``bytes accessed``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.configs.registry import ARCHS, cell_skip_reason, get_config
from repro_torch.models.model import (
    cache_logical_axes,
    forward,
    init_caches,
    init_params,
    model_flops_per_token,
    param_logical_axes,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.sharding.partitioning import DEFAULT_RULES, param_sharding

from .hlo_analysis import roofline_terms
from .hlo_cost import CostMode, tensor_bytes
from .mesh import dp_size, production_mesh_shape
from .specs import batch_logical_axes, input_specs, shape_cfg

__all__ = ["_shard_tree", "dry_run", "run_cell", "main"]


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _shard_tree(axes_tree, mesh, rules, shapes_tree=None):
    """A tree of ``NamedSharding`` for a tree of logical-axis tuples on
    ``mesh`` (a ``DeviceMesh`` or a ``MeshShape``); with ``shapes_tree`` (a
    tree of tensors or meta tensors of the same structure) each assignment
    that does not divide its dimension is dropped (``param_sharding``'s
    rule)."""
    flat_axes = tree_leaves(axes_tree)
    if not all(_is_axes(a) for a in flat_axes):
        raise ValueError("axes_tree's leaves must be tuples of logical axis names")
    if shapes_tree is None:
        out = [param_sharding(a, mesh, rules) for a in flat_axes]
    else:
        flat_shapes = tree_leaves(shapes_tree)
        if len(flat_shapes) != len(flat_axes):
            raise ValueError(f"{len(flat_axes)} axes for {len(flat_shapes)} shapes")
        out = [param_sharding(a, mesh, rules, shape=tuple(s.shape)) for a, s in zip(flat_axes, flat_shapes)]
    return tree_unflatten(axes_tree, out)


def _meta_put(x, sharding, make=torch.empty):
    """A meta tensor ``x`` as a DTensor laid out by ``sharding``: rank 0's
    shard made by ``make`` (``torch.zeros`` inside a counted step, where the
    step would write it) at the shard's shape, on ``meta``."""
    from repro_torch.sharding.compat import dtensor_api
    from repro_torch.sharding.partitioning import _local_shard

    mesh, placements = sharding.mesh, sharding.placements
    local = make(tuple(_local_shard(x, mesh, placements).shape), dtype=x.dtype, device="meta")
    stride = [1] * x.ndim
    for i in range(x.ndim - 2, -1, -1):
        stride[i] = stride[i + 1] * x.shape[i + 1]
    return dtensor_api()[0].from_local(local, mesh, placements, run_check=False, shape=x.shape, stride=tuple(stride))


def _lay_out(tree, shardings, make=torch.empty):
    """``tree``'s meta leaves made anew by ``make``: DTensors laid out by
    ``shardings`` (:func:`_meta_put`), or, without (a world of one), plain
    meta tensors of the same shapes."""
    if shardings is None:
        return tree_map(lambda x: make(x.shape, dtype=x.dtype, device="meta"), tree)
    return tree_unflatten(tree, [_meta_put(x, s, make) for x, s in zip(tree_leaves(tree), tree_leaves(shardings))])


def _local_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s leaves on this rank
    (a DTensor's local shard)."""
    seen, total = set(), 0
    for t in pytree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        local = getattr(t, "_local_tensor", t)
        key = local.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += tensor_bytes(local)
    return total


def _make_decode_fn(cfg):
    def serve_step(params, caches, tokens, positions, cross_ctx=None):
        logits, new_caches, _ = forward(
            params, cfg, tokens=tokens, positions=positions[:, None],
            mode="decode", caches=caches, cross_ctx=cross_ctx,
        )
        return logits[:, 0], new_caches

    return serve_step


def _make_prefill_fn(cfg, cache_shardings=None):
    """The prefill step; its caches are made inside it, as JAX's are, at
    each rank's shard (``cache_shardings``) on ``meta``."""
    def prefill(params, batch):
        kw = {k: v for k, v in batch.items() if k in ("tokens", "embeds", "cross_ctx")}
        if cfg.encoder_only:
            logits, _, _ = forward(params, cfg, mode="train", **kw)
            return logits
        ref = batch["tokens"] if "tokens" in batch else batch["embeds"]
        B, S = ref.shape[0], ref.shape[1]
        caches = _lay_out(init_caches(cfg, B, S, device="meta"), cache_shardings, make=torch.zeros)
        logits, new_caches, _ = forward(params, cfg, mode="prefill", caches=caches, **kw)
        return logits, new_caches

    return prefill


def _fake_group(world: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers the "fake" backend

    if dist.is_initialized():
        raise RuntimeError("a process group exists in this process: the dry-run makes its own fake group and "
                           "will not replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def dry_run(cfg: ModelConfig, shape: ShapeSpec, mesh_shape, rules=None) -> dict:
    """Count one step of ``cfg`` at ``shape`` as rank 0 of a mesh of
    ``mesh_shape`` (a ``MeshShape``; of size 1: plain meta tensors, no
    process group) and return the record's measured part: ``chips``,
    ``grad_accum``, ``lower_s``, ``compile_s``, ``memory``, ``cost``,
    ``roofline``, ``model_flops``, ``useful_flops_ratio``,
    ``tokens_per_step``. ``cfg.grad_accum`` is used as it is."""
    import torch.distributed as dist

    from repro_torch.sharding.compat import set_mesh
    from repro_torch.sharding.partitioning import axis_rules
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    rules = rules or DEFAULT_RULES
    t0 = time.monotonic()
    made = mesh_shape.size > 1
    if made:
        _fake_group(mesh_shape.size)
    try:
        mesh = None
        if made:
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh("cpu", tuple(mesh_shape.sizes), mesh_dim_names=tuple(mesh_shape.axis_names))

        def shard(axes, tree):
            return _shard_tree(axes, mesh, rules, tree) if made else None

        params_shape = init_params(0, cfg, device="meta")
        p_sh = shard(param_logical_axes(cfg), params_shape)
        params = _lay_out(params_shape, p_sh)
        batch = input_specs(cfg, shape)
        b_sh = shard(batch_logical_axes(cfg, shape), batch)
        if shape.kind == "train":
            opt_shape = adamw_init(params_shape)
            opt = {"m": _lay_out(opt_shape["m"], p_sh), "v": _lay_out(opt_shape["v"], p_sh),
                   "step": opt_shape["step"]}
            fn = make_train_step(cfg, OptConfig(), donate=True)
            args = (params, opt, batch)  # the whole batch: the step cuts each rank's rows
            arg_bytes = _local_bytes((params, opt)) + _local_bytes(_lay_out(batch, b_sh))
        elif shape.kind == "prefill":
            cache_sh = None
            if not cfg.encoder_only:
                cache_sh = shard(cache_logical_axes(cfg, shape.global_batch, shape.seq_len),
                                 init_caches(cfg, shape.global_batch, shape.seq_len, device="meta"))
            fn = _make_prefill_fn(cfg, cache_sh)
            args = (params, _lay_out(batch, b_sh))
            arg_bytes = _local_bytes(args)
        else:  # decode
            placed = _lay_out(batch, b_sh)
            args = [params, placed["caches"], placed["tokens"], placed["positions"]]
            if cfg.frontend == "vision":
                args.append(placed["cross_ctx"])
            fn = _make_decode_fn(cfg)
            arg_bytes = _local_bytes(args)
        mode = CostMode()
        mode.known(pytree_leaves(args))
        with axis_rules(rules), set_mesh(mesh):
            t_lower = time.monotonic() - t0
            with mode:
                out = fn(*args)
            t_compile = time.monotonic() - t0 - t_lower
        out_bytes = _local_bytes(out)
        del out, args
    finally:
        if made:
            dist.destroy_process_group()

    cost = mode.cost()
    roof = roofline_terms(cost)
    chips = mesh_shape.size
    # MODEL_FLOPS: 6*N_active*D train / 2*N_active*D forward per step
    tokens_per_step = (
        shape.global_batch * shape.seq_len
        if shape.kind in ("train", "prefill")
        else shape.global_batch
    )
    mf = model_flops_per_token(cfg, train=(shape.kind == "train")) * tokens_per_step
    flops_total = roof.flops_per_chip * chips
    return {
        "chips": chips,
        "grad_accum": cfg.grad_accum,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": mode.peak_bytes,
        },
        "cost": {"flops": cost.flops, "bytes accessed": cost.hbm_bytes},
        "roofline": roof.as_dict(),
        "model_flops": mf,
        "useful_flops_ratio": mf / flops_total if flops_total else None,
        "tokens_per_step": tokens_per_step,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, rules=None) -> dict:
    """Count one cell on the production mesh; return the §Dry-run/§Roofline
    record (the JAX package's keys)."""
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
    }
    skip = cell_skip_reason(arch, shape_name)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    mesh_shape = production_mesh_shape(multi_pod=multi_pod)
    cfg = shape_cfg(get_config(arch), shape, dp_size(mesh_shape))
    rec.update(dry_run(cfg, shape, mesh_shape, rules))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id, or omit for all")
    ap.add_argument("--shape", default=None, choices=list(SHAPES), help="one shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--force", action="store_true", help="recompute existing cells")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip existing] {tag}")
                    continue
                print(f"[cell] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mp)
                except Exception as e:  # a failing cell is a bug in the system
                    failures += 1
                    rec = {
                        "arch": arch,
                        "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=str)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (
                        f" dom={r['dominant']} comp={r['compute_s']:.3f}s"
                        f" mem={r['memory_s']:.3f}s coll={r['collective_s']:.3f}s"
                        f" compile={rec['compile_s']}s"
                    )
                print(f"[done] {tag}: {status}{extra}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
