"""End-to-end example: train a ~100M-param LM for a few hundred steps on the
synthetic token stream, with checkpointing/auto-resume. The port's twin of
the JAX package's ``examples/train_lm.py``: the same ``LM100M`` config,
options, schedule and output.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
      PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 30 --device cpu
(Ctrl-C triggers a clean preemption checkpoint; rerun resumes.)
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import AttnSpec, BlockSpec, ModelConfig
from repro_torch.data import lm_batches
from repro_torch.train import OptConfig, Trainer

LM100M = ModelConfig(  # ~104M params
    name="lm-100m",
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32768,
    pattern=(BlockSpec(kind="attn", attn=AttnSpec(kind="global"), ffn="swiglu"),),
    n_repeats=12,
    tie_embeddings=True,
    act_dtype="float32",
)


def main(argv=None) -> dict:
    """Runs the example; returns the per-step losses and seconds, the
    first-10 and last-10 mean losses (``None`` unless more than 20 steps
    ran), the trainer, its state and step, and the device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="checkpoints/lm100m")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = LM100M
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    opt = OptConfig(lr=6e-4, warmup_steps=30, decay_steps=args.steps)
    trainer = Trainer(cfg, opt, args.ckpt_dir, ckpt_every=50, device=args.device)
    state = trainer.init_or_resume()
    print("state:", state, "step", trainer.step)

    losses, step_time = [], []

    def log(step, m):
        losses.append(m["loss"])
        step_time.append(m["step_time"])
        if step % 10 == 0:
            print(f"step {step:4d}  loss {m['loss']:.4f}  lr {m.get('lr', 0):.2e}  "
                  f"{m['step_time']*1e3:.0f} ms/step")

    batches = lm_batches(cfg.vocab_size, args.batch, args.seq, args.steps, seed=trainer.step + 1)
    trainer.run(batches, max_steps=args.steps, log_fn=log)
    first10 = last10 = None
    if len(losses) > 20:
        first10, last10 = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
        print(f"\nloss: first10 {first10:.4f} -> last10 {last10:.4f}")
    return {"losses": losses, "step_time": step_time, "first10": first10, "last10": last10, "state": state,
            "step": trainer.step, "device": str(trainer.device), "trainer": trainer}


if __name__ == "__main__":
    main()
