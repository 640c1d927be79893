"""Training launcher: the port of the JAX package's ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch stablelm-1.6b --steps 1000 \\
        --ckpt-dir checkpoints
    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke --steps 5 --device cpu

The options, defaults and types are the JAX launcher's, and so are its
``OptConfig`` (``warmup_steps=min(100, steps // 10 + 1)``,
``decay_steps=steps``) and its batches (``lm_batches(..., seed=trainer.step)``),
so one command line trains on the same data in both packages. Training runs
on one device: ``--mesh`` and ``--distributed`` raise ``NotImplementedError``
until the LM sharding slice of the port (ROADMAP A11c). ``--device`` is the
port's own (default: the CUDA card).
"""
from __future__ import annotations

import argparse
import time

import torch


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
    the final metrics."""
    from repro_torch._device import resolve_device
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data import lm_batches
    from repro_torch.train import OptConfig, Trainer

    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    opt = OptConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1), decay_steps=steps)
    trainer = Trainer(cfg, opt, ckpt_dir, ckpt_every=ckpt_every, device=dev)
    state = trainer.init_or_resume()
    first = trainer.step
    per_step = {"loss": [], "grad_norm": [], "lr": [], "step_time": []}

    def log(step, m):
        for k in per_step:
            per_step[k].append(m[k])
        if log_fn is not None:
            log_fn(step, m)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    batches = lm_batches(cfg.vocab_size, batch, seq, steps, seed=trainer.step)
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
    if args.mesh or args.distributed:
        raise NotImplementedError(
            "--mesh and --distributed shard the train state, which needs the port's LM "
            "sharding layer (ROADMAP A11c, not ported yet)")

    def log(step, m):
        if step % 10 == 0 or step == 1:
            print(
                f"  step {step:5d} loss {m['loss']:.4f} "
                f"gnorm {m.get('grad_norm', 0):.2f} {m['step_time']*1e3:.0f}ms"
            )

    st = train_lm(args.arch, args.smoke, args.steps, args.batch, args.seq, args.lr, args.ckpt_dir,
                  args.ckpt_every, args.device, log_fn=log)
    print(f"[train] {st['arch']} on {st['device']}: {st['state']} at step {st['first_step']}")
    print(f"[train] done at step {st['last_step']}: {st['final']}")
    return st


if __name__ == "__main__":
    main()
