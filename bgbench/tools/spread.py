"""The runs a bound is set from: for each cell, two sets of runs on the same
seeds, each run a fresh ``bgbench/run.py`` process, the two runs of a seed
one after the other (a pair, as a check runs the parent's and the change's),
the pair's order alternating; then traced runs on seeds of their own.

    python3 bgbench/tools/spread.py --workloads fullhd-r4.batch16,fullhd-r12.batch16 \
        --seeds 11,12,13,14,15,16 --traced-seeds 21,22,23 --seconds 51 \
        [--light fullhd-r12.live60 --light-seconds 5]

The cells take turns seed by seed, and ``--light`` runs another cell briefly
after every pair: a batch cell's speed is a property of the process, which
the next process of the same cell tends to inherit, so a cell's runs made
back to back spread less than the same runs between other work, as a queue
of checks makes them (``PERF.md`` §2).

One JSON line per run on standard output (the cell, the set, the seed, the
result line's metrics, checks and device). On standard error, per cell and
metric: each set's median and spread (quartile distance over the median,
``statistics.quantiles``), the same with each set's run farthest from its
median left out, the spread of all the runs together, and the second set's
median against the first's; the traced runs' per-layer medians.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values):
    """``values`` less the one farthest from their median."""
    m = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - m))
    return values[:far] + values[far + 1:]


def run(cell, seed, seconds, trace):
    proc = subprocess.run([sys.executable, "bgbench/run.py", "--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          capture_output=True, text=True, cwd=str(ROOT), timeout=1500)
    if proc.returncode != 0 or not proc.stdout.strip():
        return {"rc": proc.returncode, "error": proc.stderr[-2000:]}
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"rc": 0, "correct": result["correct"], "attempted": result["attempted"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "checks": result["checks"], "device": result["device"],
            "breakdown": result.get("breakdown")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--traced-seeds", default="")
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--light", default="")
    ap.add_argument("--light-seconds", type=float, default=5)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    traced = [int(s) for s in args.traced_seeds.split(",") if s]
    cells = args.workloads.split(",")
    every = []
    for k, seed in enumerate(seeds):
        for cell in cells:
            for side in ("AB" if k % 2 == 0 else "BA"):
                row = {"cell": cell, "set": side, "seed": seed, "trace": 0,
                       **run(cell, seed, args.seconds, 0)}
                every.append(row)
                print(json.dumps(row), flush=True)
            if args.light:
                run(args.light, seed, args.light_seconds, 0)
    for cell in cells:
        for seed in traced:
            row = {"cell": cell, "set": "traced", "seed": seed, "trace": 1,
                   **run(cell, seed, args.seconds, 1)}
            every.append(row)
            print(json.dumps(row), flush=True)
    for cell in cells:
        rows = [r for r in every if r["cell"] == cell]
        bad = [r["seed"] for r in rows if r["rc"] != 0 or not r["correct"]]
        print(f"{cell}: {len(rows)} runs, not correct or failed: {bad}", file=sys.stderr)
        sets = {s: [r for r in rows if r["set"] == s and r["rc"] == 0] for s in "AB"}
        for name in sorted({k for r in sets["A"] + sets["B"] for k in r["metrics"]}):
            v = {s: [r["metrics"][name] for r in sets[s] if name in r["metrics"]] for s in "AB"}
            if min(len(v["A"]), len(v["B"])) < 3:
                continue
            ma, mb = statistics.median(v["A"]), statistics.median(v["B"])
            print(f"{cell} {name}: medians {ma!r} {mb!r} (B/A-1 {mb / ma - 1:+.5f}); spreads "
                  f"{spread(v['A']):.5f} {spread(v['B']):.5f}; trimmed {spread(trimmed(v['A'])):.5f} "
                  f"{spread(trimmed(v['B'])):.5f}; all {spread(v['A'] + v['B']):.5f}; runs "
                  f"{[round(x, 4) for x in v['A']]} {[round(x, 4) for x in v['B']]}", file=sys.stderr)
        tr = [r for r in rows if r["set"] == "traced" and r["rc"] == 0]
        for name in sorted({k for r in tr for k in r["metrics"]}):
            vals = [r["metrics"][name] for r in tr if name in r["metrics"]]
            print(f"{cell} traced {name}: median {statistics.median(vals)!r} runs {vals}",
                  file=sys.stderr)
        for r in tr:
            dev = r["device"]
            print(f"{cell} traced seed {r['seed']}: busy {dev['busy_s']!r} window {dev['window_s']!r}"
                  f" peak {dev['memory_peak_bytes']} ops {r['breakdown']['device_ops'][:3]}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
