"""Rank programs for ``tests/test_torch_lm_sharding.py``: the port's LM
sharding on CPU ``gloo`` process groups.

    python tests/torch_lm_ranks.py <case> <world size> <work dir>

spawns ``world size`` ranks; each joins the group through a ``file://``
store in ``work dir`` (never a fixed port), runs on one thread and runs the
case's parts. The inputs come from ``work dir/inputs.pt`` (written by the
test from the JAX package's numbers); rank 0 writes what the test compares
to ``work dir/results.pt``. Imports the port only (no JAX).
"""
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _lay_out(tree, mesh, cfg):
    from repro_torch.checkpoint.elastic import lay_out
    from repro_torch.launch.dryrun import _shard_tree
    from repro_torch.models import param_logical_axes
    from repro_torch.sharding.partitioning import DEFAULT_RULES

    return lay_out(tree, _shard_tree(param_logical_axes(cfg), mesh, DEFAULT_RULES, tree))


def _full(tree):
    from repro_torch.models import tree_map

    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, tree)


def sharded_step(arch, inp, mesh):
    """One smoke train step on ``mesh`` from the test's parameters and
    batch; returns what the test compares (loss, grad norm, the gathered
    new params and first moments: after one AdamW step ``m`` is the clipped
    gradient times ``1 - b1``) and the DTensor state."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.sharding.compat import set_mesh
    from repro_torch.sharding.partitioning import DEFAULT_RULES, axis_rules
    from repro_torch.train import OptConfig, init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    params = inp["params"][arch]
    state = init_train_state(params)
    with axis_rules(DEFAULT_RULES), set_mesh(mesh):
        pd = _lay_out(params, mesh, cfg)
        sd = {"m": _lay_out(state["m"], mesh, cfg), "v": _lay_out(state["v"], mesh, cfg), "step": state["step"]}
        p_new, s_new, m = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10))(
            pd, sd, inp["batch"][arch])
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "params": _full(p_new),
            "m": _full(s_new["m"])}, (p_new, s_new)


def elastic_check(arch, mesh, ckpt_dir, step):
    """Restore ``ckpt_dir``'s ``step`` onto ``mesh``: each leaf's placements
    against ``train_state_shardings`` and its gathered value."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.elastic import elastic_restore, train_state_shardings
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import tree_leaves

    cfg = get_smoke_config(arch)
    p, o, meta = elastic_restore(CheckpointManager(ckpt_dir), cfg, mesh, step=step)
    p_sh, o_sh = train_state_shardings(cfg, mesh)
    placed = all(tuple(t.placements) == s.placements
                 for t, s in zip(tree_leaves({"p": p, "o": o}), tree_leaves({"p": p_sh, "o": o_sh})))
    return {"meta_step": meta["step"], "placements_as_train_state_shardings": placed,
            "restored": _full({"params": p, "opt": o})}


def case_mesh22(rank, inp, work):
    """4 ranks: every arch on (2, 2); the last one's state checkpointed
    under (2, 2) and restored under (4, 1); compression over a DeviceMesh;
    the launcher."""
    from repro_torch.models import tree_leaves
    from repro_torch.sharding import BatchMesh
    from repro_torch.train import compressed_mean_grads

    out = {"steps": {}}
    mesh = _mesh((2, 2), ("data", "model"))
    state = None
    for arch in inp["archs"]:
        out["steps"][arch], state = sharded_step(arch, inp, mesh)
    out["norm_of_partial"] = _norm_of_partial(mesh)
    out["uneven_put"] = _uneven_put(mesh)
    out["elastic_22_to_41"] = _elastic_22_to_41(inp["archs"][-1], state, work)
    # compressed mean over a 4-rank data axis: JAX's form and the BatchMesh form
    g = inp["grads"]
    red = compressed_mean_grads({"w": g}, _mesh((4,), ("data",)), dp_axes=("data",))["w"].full_tensor()
    batch = compressed_mean_grads({"w": g}, BatchMesh(("cpu",) * 4), dp_axes=("batch",))["w"]
    out["compress"] = {"mesh": red, "batch_mesh": batch}
    # the launcher on the 4 ranks
    from repro_torch.launch.train import main

    st = main(["--arch", "stablelm-1.6b", "--smoke", "--mesh", "2x2", "--steps", "3", "--batch", "4",
               "--seq", "8", "--ckpt-dir", os.path.join(work, "launch22"), "--device", "cpu"])
    out["launcher"] = {"loss": st["loss"], "mesh": st["mesh"], "world_size": st["world_size"],
                       "on_mesh": all(hasattr(t, "placements") for t in tree_leaves(st["trainer"].params))}
    return out


def _norm_of_partial(mesh):
    """``global_norm`` of a tree holding a ``Partial`` leaf (each data rank
    holds an addend, as a replicated parameter's gradient comes out of a
    batch-sharded backward pass) beside a sharded one, and the norm of the
    same leaves gathered whole."""
    from repro_torch.sharding.compat import dtensor_api
    from repro_torch.train import global_norm

    DTensor, Shard, Replicate, Partial, distribute_tensor = dtensor_api()
    base = torch.linspace(-1.0, 2.0, 12)
    addend = base * (mesh.get_coordinate()[0] + 1)  # the same on the ranks of a data row
    tree = {"partial": DTensor.from_local(addend, mesh, [Partial(), Replicate()], run_check=False),
            "sharded": distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh, [Shard(0), Shard(1)])}
    whole = {k: v.full_tensor() for k, v in tree.items()}
    return {"norm": float(global_norm(tree)), "whole": float(global_norm(whole))}


def _uneven_put(mesh):
    """``device_put`` of full tensors whose sharded dims do not divide
    their mesh axes (one of them over both axes): each rank's local piece
    against DTensor's own cut (``distribute_tensor``), and the gathered
    value against the input."""
    from repro_torch.sharding.compat import dtensor_api
    from repro_torch.sharding.partitioning import NamedSharding, PartitionSpec, device_put

    distribute_tensor = dtensor_api()[4]
    out = []
    for shape, spec in [((5, 3), PartitionSpec("data", "model")), ((7, 2), PartitionSpec(("data", "model"))),
                        ((3, 1), PartitionSpec(None, "model"))]:
        x = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
        sh = NamedSharding(mesh, spec)
        got, want = device_put(x, sh), distribute_tensor(x, mesh, sh.placements)
        out.append({"shape": shape, "local_equal": torch.equal(got.to_local(), want.to_local()),
                    "full_equal": torch.equal(got.full_tensor(), x)})
    return out


def _elastic_22_to_41(arch, state, work):
    """``arch``'s DTensor state, checkpointed under (2, 2) and restored under
    (4, 1)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import tree_leaves

    p_new, s_new = state
    ckpt = os.path.join(work, "ckpt22")
    CheckpointManager(ckpt, async_save=False).save(1, {"params": p_new, "opt": s_new})
    want = _full({"params": p_new, "opt": s_new})
    # ... restored under (4, 1)
    got = elastic_check(arch, _mesh((4, 1), ("data", "model")), ckpt, 1)
    got["equal_to_saved"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(got.pop("restored")),
                                                                  tree_leaves(want)))
    return got


def case_mesh8(rank, inp, work):
    """8 ranks: yi-6b on (2, 4); ring attention on an 8-rank data axis; GPipe
    with 4 stages on (4, 2); a JAX checkpoint restored onto (4, 2)."""
    from repro_torch.configs.base import AttnSpec
    from repro_torch.sharding.pipeline_parallel import gpipe
    from repro_torch.sharding.ring_attention import ring_attention

    out = {"steps": {}}
    mesh = _mesh((2, 4), ("data", "model"))
    for arch in inp["archs"]:
        out["steps"][arch], _ = sharded_step(arch, inp, mesh)
    ring = _mesh((8,), ("data",))
    r = inp["ring"]
    out["ring"] = []
    for spec, cap in [(AttnSpec(kind="global"), 0.0), (AttnSpec(kind="global", causal=False), 0.0),
                      (AttnSpec(kind="local", window=24), 0.0), (AttnSpec(kind="global"), 30.0)]:
        o = ring_attention(r["q"], r["k"], r["v"], r["pos"], spec, ring, axis="data", softcap=cap)
        out["ring"].append(o.full_tensor())
    pipe = _mesh((4, 2), ("pipe", "x"))
    out["gpipe"] = gpipe(lambda w, x: torch.tanh(x @ w), inp["gpipe"]["ws"], inp["gpipe"]["xs"], pipe,
                         axis="pipe").full_tensor()
    out["elastic_jax_to_42"] = elastic_check(inp["elastic_arch"], _mesh((4, 2), ("data", "model")),
                                             inp["jax_ckpt"], None)
    return out


CASES = {"mesh22": case_mesh22, "mesh8": case_mesh8}


def _rank(rank, world, case, work):
    torch.set_num_threads(1)
    import logging
    import warnings

    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(work, "store"), rank=rank,
                            world_size=world)
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        out = CASES[case](rank, inp, work)
        if rank == 0:
            torch.save(out, os.path.join(work, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, world, work = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_rank, args=(world, case, work), nprocs=world)
