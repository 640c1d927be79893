"""The readings that the limits of ``correct`` are set from: the program's
compared numbers over many seeds, and the control's, at each cell's own
size and load, in one process on the card.

    python3 bgbench/tools/readings.py --workloads fullhd-r12.batch16,fullhd-r12.live60 \
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3

The control is the program with its own lower-precision path switched on:
``plan_for(precision="bf16")``, bf16 storage of the frames, grids, carries
and outputs (the configuration states fp32). Each run prints one JSON line:
the workload, the seed, the precision, the plan and the compared numbers.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(BENCH_DIR.parent / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from harness.spec import Spec
    from harness.drive import drive

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    for cell in args.workloads.split(","):
        spec = Spec.from_file(BENCH_DIR.parent / "BENCHMARK.json", cell)
        for precision, group in ((None, seeds), ("bf16", control)):
            for seed in group:
                t = time.perf_counter()
                try:
                    run = drive(spec, seed, args.seconds, False, torch.device("cuda", 0), t,
                                precision=precision)
                except RuntimeError as exc:  # a control that crashes has failed
                    print(json.dumps({"workload": cell, "seed": seed, "precision": precision,
                                      "error": repr(exc)[:300]}), flush=True)
                    continue
                print(json.dumps({"workload": cell, "seed": seed,
                                  "precision": precision or "fp32", "plan": run.plan,
                                  "correct": run.verdict.correct, **run.verdict.numbers(),
                                  "seconds": time.perf_counter() - t}), flush=True)
                del run
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
