"""The knee sweep of a live (open-loop) cell: the cell's traffic at each
stream count S, one short window each, in one process on the card.

    python3 bgbench/tools/sweep_live.py --workload fullhd-r12.live60 --streams 64,128,192 --seconds 4

For each S it prints the p50, p95 and largest latency from due time to
completion, the frames/s completed, the packer's host ms per pack, how late
the generator ran at the end, and the backlog at the last due time (packs
sent and not yet complete). The knee is the largest S whose backlog does
not grow and whose p95 stays within the frame period; the cell runs at
4/5 of it. No comparison is made (``drive(check=False)``)."""
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", required=True, help="comma-separated stream counts")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=1234567)
    ap.add_argument("--trace", action="store_true", help="also print each point's busiest device ops")
    args = ap.parse_args(argv)

    import torch

    from harness.spec import Spec
    from harness.drive import drive
    from harness.stats import percentile

    if not torch.cuda.is_available():
        print("sweep_live: needs a CUDA card", file=sys.stderr)
        return 3
    for n in (int(s) for s in args.streams.split(",")):
        spec = Spec.from_file(BENCH_DIR.parent / "BENCHMARK.json", args.workload)
        spec.traffic["streams"] = n
        try:
            run = drive(spec, args.seed, args.seconds, args.trace, torch.device("cuda", 0),
                        time.perf_counter(), check=False)
        except (RuntimeError, ValueError) as exc:  # out of memory, a refused plan
            print(json.dumps({"streams": n, "error": repr(exc)[:300]}), flush=True)
            torch.cuda.empty_cache()
            continue
        last_due = max(d for d, _ in run.packs)
        pack_ms = [1e3 * (b - a) for a, b in run.spans["pack"]]
        print(json.dumps({
            "streams": n, "plan": run.plan,
            "p50_ms": percentile(run.latencies_ms, 50), "p95_ms": percentile(run.latencies_ms, 95),
            "max_ms": max(run.latencies_ms), "frames_per_s": run.completed / run.window_s,
            "offered_per_s": n * float(spec.traffic["fps"]),
            "packer_host_ms": sum(pack_ms) / len(pack_ms),
            "lateness_end_ms": run.lateness_ms[-1], "lateness_max_ms": max(run.lateness_ms),
            "backlog_end": sum(1 for _, t in run.packs if t > last_due),
            "memory_peak_bytes": run.memory_peak_bytes}), flush=True)
        if run.trace is not None:
            print(json.dumps({"streams": n, "busy_s": run.trace.busy_s,
                              "window_s": run.trace.window_s, "ops": len(run.trace.ops),
                              "device_ops": run.trace.top_ops(12)}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
