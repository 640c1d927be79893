"""One run of a cell, reduced to the result line: the metrics the cell
lists (end-to-end untraced, per-layer traced), each read by its own
reader, the device, the traced run's breakdown, and the numbers that
decided ``correct`` beside their limits."""
from __future__ import annotations

import torch

from .drive import drive
from .stats import percentile

__all__ = ["run_cell"]


def run_cell(spec, seed: int, seconds: float, traced: bool, device, t_start: float,
             precision=None):
    """Returns ``(result, notes)``: the result line's object and the lines
    for standard error (the generator's lateness, the plan, the checks)."""
    device = torch.device(device)
    run = drive(spec, seed, seconds, traced, device, t_start, precision=precision)
    metrics = {}
    for m in spec.metrics(traced):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(spec.cell["chips"]),
           "memory_peak_bytes": run.memory_peak_bytes}
    notes = [f"plan: {run.plan}"]
    if run.lateness_ms:
        late = sorted(run.lateness_ms)
        notes.append(f"generator lateness ms: median {late[len(late) // 2]!r} "
                     f"max {late[-1]!r} over {len(late)} packs")
        t0 = run.packs[0][0]
        by_second: dict = {}
        for due, done in run.packs:
            by_second.setdefault(int(due - t0), []).append(1e3 * (done - due))
        notes.append("pack latency p95 ms by second of the window: "
                     + " ".join(f"{percentile(v, 95):.3f}" for _, v in sorted(by_second.items())))
    result = {"correct": run.verdict.correct, "attempted": run.attempted,
              "failed": run.attempted - run.completed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps(run.spans)}
    checks = run.verdict.numbers()
    result["checks"] = checks  # the contract asks for the compared numbers last in the line
    notes.append(f"check seconds: {run.check_s!r}")
    for name in ("max_lsb", "mismatch_share"):
        notes.append(f"check {name}: {checks[name]['value']!r} limit {checks[name]['limit']!r}")
    notes.append(f"check frames_checked: {checks['frames_checked']}")
    return result, notes
