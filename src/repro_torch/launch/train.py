"""Training launcher: the port of the JAX package's ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch stablelm-1.6b --steps 1000 \\
        --ckpt-dir checkpoints
    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke --steps 5 --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch yi-6b --smoke \
        --mesh 2x2 --distributed --device cpu

The options, defaults and types are the JAX launcher's, and so are its
``OptConfig`` (``warmup_steps=min(100, steps // 10 + 1)``,
``decay_steps=steps``) and its batches (``lm_batches(..., seed=trainer.step)``),
so one command line trains on the same data in both packages. ``--device``
is the port's own (default: the CUDA card).

``--distributed`` joins the process group torchrun's environment describes
(``nccl`` on the card, ``gloo`` on the CPU; JAX's
``jax.distributed.initialize()``). ``--mesh AxB`` lays the train state out
on an ``A x B`` ``("data", "model")`` ``DeviceMesh`` by its logical axes and
trains under ``axis_rules(DEFAULT_RULES)`` and ``set_mesh``, as JAX does.
The mesh needs as many ranks as it has devices: without ``--distributed``
a mesh of one gets a world-1 group made in this process, any other size
raises. Nothing moves to the CPU or to ``gloo`` on its own.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import time

import torch
import torch.distributed as dist


def train_lm(
    arch: str,
    smoke: bool = False,
    steps: int = 200,
    batch: int = 8,
    seq: int = 256,
    lr: float = 3e-4,
    ckpt_dir: str = "checkpoints",
    ckpt_every: int = 100,
    device=None,
    log_fn=None,
    mesh=None,
    distributed: bool = False,
) -> dict:
    """Train ``arch`` (its smoke config with ``smoke``) for up to ``steps``
    steps of ``batch`` x ``seq`` synthetic tokens through ``Trainer`` on
    ``device`` (default: the CUDA card), resuming from ``ckpt_dir``'s latest
    checkpoint and saving every ``ckpt_every`` steps and at the end, as the
    JAX launcher does. ``log_fn(step, metrics)`` sees every step.

    Returns the per-step ``loss``, ``grad_norm``, ``lr`` and ``step_time``
    (seconds, each ending when the step's metrics reach the host), the
    trainer's ``save_seconds`` (each save call's blocking time), the
    tokens/s over the steps after the first (the first carries one-time
    costs; ``None`` with fewer than two steps), ``max_memory_allocated`` on a
    card (after a reset before the first step), the first and last step and
    the final metrics.

    ``mesh`` (``"AxB"``, the CLI's ``--mesh``) and ``distributed`` are the
    launcher's options (see the module docstring); a process group this
    call made is destroyed before it returns. With a mesh the result also
    has ``mesh`` (its shape) and ``world_size``."""
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    if distributed and dev.type == "cuda" and not dist.is_initialized():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))  # each rank its own card
        dev = resolve_device(device)
    made_group = _join_group(dev, mesh, distributed)
    try:
        return _train(arch, smoke, steps, batch, seq, lr, ckpt_dir, ckpt_every, dev, log_fn, mesh)
    finally:
        if made_group:
            dist.destroy_process_group()


def _mesh_dims(mesh: str) -> tuple:
    return tuple(int(x) for x in mesh.split("x"))


def _join_group(dev: torch.device, mesh, distributed: bool) -> bool:
    """Join the process group the options ask for; True if this call made
    it. ``distributed``: torchrun's environment (``nccl`` for a card,
    ``gloo`` for the CPU). Otherwise a mesh of one device gets a world-1
    group in this process (an in-process store) and a larger one raises,
    naming the ranks it needs; a group already joined is used as it is."""
    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if distributed:
        dist.init_process_group(backend)
        return True
    if mesh is None:
        return False
    size = math.prod(_mesh_dims(mesh))
    if size != 1:
        raise ValueError(f"--mesh {mesh} needs a process group of {size} ranks: run it under torchrun "
                         f"--nproc-per-node {size} with --distributed")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def _train(arch, smoke, steps, batch, seq, lr, ckpt_dir, ckpt_every, dev, log_fn, mesh) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.elastic import lay_out
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data import lm_batches
    from repro_torch.launch.dryrun import _shard_tree
    from repro_torch.models import param_logical_axes
    from repro_torch.sharding.compat import set_mesh
    from repro_torch.sharding.partitioning import DEFAULT_RULES, axis_rules
    from repro_torch.train import OptConfig, Trainer

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    opt = OptConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1), decay_steps=steps)
    trainer = Trainer(cfg, opt, ckpt_dir, ckpt_every=ckpt_every, device=dev)
    dims = dmesh = None
    if mesh is not None:
        dims = _mesh_dims(mesh)
        if dist.get_world_size() != math.prod(dims):
            raise ValueError(f"--mesh {mesh} needs {math.prod(dims)} ranks, the process group has "
                             f"{dist.get_world_size()}")
        dmesh = init_device_mesh(dev.type, dims, mesh_dim_names=("data", "model")[: len(dims)])

    def on_mesh():
        stack = contextlib.ExitStack()
        if dmesh is not None:
            stack.enter_context(axis_rules(DEFAULT_RULES))
            stack.enter_context(set_mesh(dmesh))
        return stack

    # under the mesh a resume puts each leaf straight onto it (Trainer.init_or_resume)
    with on_mesh():
        state = trainer.init_or_resume()
    first = trainer.step
    if mesh is not None:
        p_sh = _shard_tree(param_logical_axes(cfg), dmesh, DEFAULT_RULES, trainer.params)
        trainer.params = lay_out(trainer.params, p_sh)
        trainer.opt_state = {
            "m": lay_out(trainer.opt_state["m"], p_sh),
            "v": lay_out(trainer.opt_state["v"], p_sh),
            "step": trainer.opt_state["step"],
        }
    per_step = {"loss": [], "grad_norm": [], "lr": [], "step_time": []}

    def log(step, m):
        for k in per_step:
            per_step[k].append(m[k])
        if log_fn is not None:
            log_fn(step, m)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    batches = lm_batches(cfg.vocab_size, batch, seq, steps, seed=trainer.step)
    with on_mesh():
        t0 = time.perf_counter()
        final = trainer.run(batches, max_steps=steps, log_fn=log)
        seconds = time.perf_counter() - t0
    later = per_step["step_time"][1:]
    return {
        "arch": cfg.name,
        "state": state,
        "first_step": first,
        "last_step": trainer.step,
        "batch": batch,
        "seq": seq,
        **per_step,
        "tokens_per_s": batch * seq * len(later) / sum(later) if later else None,
        "seconds": seconds,
        "save_seconds": trainer.save_seconds,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "param_count": cfg.param_count(),
        "final": final,
        "device": str(dev),
        "trainer": trainer,
        **({"mesh": list(dims), "world_size": dist.get_world_size()} if dims else {}),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--mesh", default=None, help="e.g. 4x2 => (data,model)")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    def log(step, m):
        if step % 10 == 0 or step == 1:
            print(
                f"  step {step:5d} loss {m['loss']:.4f} "
                f"gnorm {m.get('grad_norm', 0):.2f} {m['step_time']*1e3:.0f}ms"
            )

    st = train_lm(args.arch, args.smoke, args.steps, args.batch, args.seq, args.lr, args.ckpt_dir,
                  args.ckpt_every, args.device, log_fn=log, mesh=args.mesh, distributed=args.distributed)
    print(f"[train] {st['arch']} on {st['device']}: {st['state']} at step {st['first_step']}")
    print(f"[train] done at step {st['last_step']}: {st['final']}")
    return st


if __name__ == "__main__":
    main()
