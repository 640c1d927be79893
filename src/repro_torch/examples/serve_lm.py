"""Serve a small model with batched requests through the continuous-batching
engine (slot reuse, per-request positions, greedy sampling). The port's
twin of the JAX package's ``examples/serve_lm.py``: the same config, slots
and request mix, on the port's own seeded parameters.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm
      PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serving import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("yi-6b")
    params = init_params(0, cfg, device=dev)
    eng = ServeEngine(cfg, params, max_slots=4, max_len=128, device=dev)

    requests = [
        Request(uid=i, prompt=[(3 * i + j) % cfg.vocab_size for j in range(3 + i)],
                max_tokens=args.max_tokens)
        for i in range(args.requests)
    ]
    queue = list(requests)
    t0 = time.perf_counter()
    finished = steps = 0
    while finished < len(requests):
        while queue and eng.submit(queue[0]):
            queue.pop(0)
        finished += len(eng.step())
        steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in requests)
    print(f"{len(requests)} requests / {toks} tokens in {dt:.2f}s on {dev} "
          f"({steps} engine steps, {toks / dt:.0f} tok/s, 4 slots)")
    for r in requests[:3]:
        print(f"  uid={r.uid}: {r.prompt} -> {r.generated}")
    return {"requests": len(requests), "tokens": toks, "steps": steps, "seconds": dt,
            "tokens_per_s": toks / dt, "generated": [r.generated for r in requests],
            "device": str(dev)}


if __name__ == "__main__":
    main()
