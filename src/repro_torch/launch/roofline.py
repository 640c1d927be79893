"""Roofline report generators: dryrun cells and plan-sweep records -> markdown,
the port of the JAX package's ``repro/launch/roofline.py`` (pure Python: for
the same records it renders the same strings).

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir results/torch_dryrun
    PYTHONPATH=src python -m repro_torch.launch.roofline --plan-sweep sweep.json

``chip_smoke.py`` (phase ``dryrun_slice``) renders its ``plan_sweep`` rows
with :func:`render_plan_sweep_table`.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

__all__ = [
    "load_cells",
    "render_roofline_table",
    "render_dryrun_table",
    "render_plan_sweep_table",
]


def load_cells(directory: str):
    cells = []
    for p in sorted(glob.glob(os.path.join(directory, "*.json"))):
        cells.append(json.load(open(p)))
    return cells


def _fix(rec):
    """Roofline fraction: bound term / achievable (compute term)."""
    r = rec["roofline"]
    bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
    return r["compute_s"] / bound if bound > 0 else 0.0


def render_dryrun_table(cells) -> str:
    out = ["| arch | shape | mesh | status | bytes/dev (arg+tmp+out) | compile s | collectives (count) |",
           "|---|---|---|---|---|---|---|"]
    for r in cells:
        if r["status"] == "skipped":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP: {r['reason']} | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | — | — | — |")
            continue
        m = r["memory"]
        total = sum(m.get(k, 0) for k in
                    ("argument_size_in_bytes", "temp_size_in_bytes",
                     "output_size_in_bytes"))
        colls = r["roofline"]["collective_breakdown"]
        cstr = ", ".join(f"{k}×{int(v['count'])}" for k, v in sorted(colls.items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{total/1e9:.1f} GB | {r['compile_s']:.0f} | {cstr or '—'} |"
        )
    return "\n".join(out)


def render_roofline_table(cells, mesh: str = "16x16") -> str:
    out = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS/HLO_FLOPs | roofline fraction |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in cells:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3f} | "
            f"{rf['memory_s']:.3f} | {rf['collective_s']:.3f} | "
            f"**{rf['dominant']}** | {r.get('useful_flops_ratio', 0):.3f} | "
            f"{_fix(r)*100:.1f}% |"
        )
    return "\n".join(out)


def _plan_label(plan: dict) -> str:
    bt = plan.get("batch_tile")
    return f"{plan.get('backend', '?')}/bt{bt if bt is not None else 'auto'}"


def render_plan_sweep_table(records) -> str:
    """The paper-style model-predicted-vs-measured-best plan table.

    ``records`` is the list the JAX package's ``benchmarks/bench_plan_sweep``
    emits, and ``chip_smoke.py``'s ``plan_sweep`` phase on the card: one dict
    per workload with ``workload`` (label), ``candidates`` (each with
    ``plan`` = a ``BGPlan.to_json`` payload, ``model_us``, ``measured_us``),
    ``model_pick`` / ``measured_best`` (candidate indices), and ``regret``
    (measured time of the model's pick / measured best — 1.00 means the
    roofline model found the true winner).
    """
    out = [
        "| workload | candidates | model pick | pred us | measured best | "
        "best us | regret |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in records:
        cands = r["candidates"]
        mp, mb = cands[r["model_pick"]], cands[r["measured_best"]]
        out.append(
            f"| {r['workload']} | {len(cands)} | {_plan_label(mp['plan'])} | "
            f"{mp['model_us']:.1f} | {_plan_label(mb['plan'])} | "
            f"{mb['measured_us']:.1f} | {r['regret']:.2f}x |"
        )
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/torch_dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument(
        "--plan-sweep",
        default=None,
        metavar="JSON",
        help="render the model-vs-measured table from a plan-sweep "
        "records file instead of the dryrun report",
    )
    args = ap.parse_args(argv)
    if args.plan_sweep:
        records = json.load(open(args.plan_sweep))
        print("## Plan sweep: model-predicted vs measured-best\n")
        print(render_plan_sweep_table(records))
        return
    cells = load_cells(args.dir)
    print("## Dry-run\n")
    print(render_dryrun_table(cells))
    print("\n## Roofline (single-pod)\n")
    print(render_roofline_table(cells, args.mesh))


if __name__ == "__main__":
    main()
