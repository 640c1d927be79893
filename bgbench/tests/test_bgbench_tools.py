"""The tool a bound is set from (``tools/spread.py``), with the runs
stubbed out: its statistics are the ones the bounds are defined by, and the
runs come in the order a check makes them."""
import json
import statistics
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.spec import load_module  # noqa: E402

spread_tool = load_module(BENCH / "tools" / "spread.py", "bgbench_tool_spread")


def test_spread_is_the_quartile_distance_over_the_median():
    values = [100.0, 101.0, 99.0, 104.0, 100.5, 98.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert spread_tool.spread(values) == pytest.approx((q3 - q1) / 100.25)
    assert spread_tool.spread([7.0, 7.0, 7.0]) == 0.0
    assert spread_tool.spread([1.0]) != spread_tool.spread([1.0])  # nan: one run has no spread


def test_trimmed_leaves_out_the_run_farthest_from_the_median():
    assert spread_tool.trimmed([10.0, 10.2, 9.9, 12.0, 10.1]) == [10.0, 10.2, 9.9, 10.1]
    assert spread_tool.trimmed([5.0, 1.0, 5.1, 5.2]) == [5.0, 5.1, 5.2]


def test_spread_tool_runs_each_seed_twice_in_a_row_then_the_traced(monkeypatch, capsys):
    calls = []

    def fake(cell, seed, seconds, trace):
        calls.append((cell, seed, trace))
        fps = 1000.0 + seed + (0.5 if len(calls) % 2 else 0.0)
        out = {"rc": 0, "correct": True, "attempted": 10, "checks": {}, "metrics": {},
               "device": {"busy_s": 0.9, "window_s": 1.0, "memory_peak_bytes": 5},
               "breakdown": {"device_ops": [["k", 0.8]]}}
        out["metrics"] = {"frame_roofline.batch": 20.0} if trace else {"frames_per_s": fps}
        return out

    monkeypatch.setattr(spread_tool, "run", fake)
    assert spread_tool.main(["--workloads", "c1", "--seeds", "1,2,3", "--traced-seeds", "9",
                             "--seconds", "2"]) == 0
    assert calls == [("c1", 1, 0), ("c1", 1, 0), ("c1", 2, 0), ("c1", 2, 0), ("c1", 3, 0),
                     ("c1", 3, 0), ("c1", 9, 1)]
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.splitlines()]
    assert [r["set"] for r in rows] == ["A", "B", "B", "A", "A", "B", "traced"]
    # set A holds the first run of seeds 1 and 3 and the second of seed 2: 1001.5, 1002, 1003.5
    assert "c1 frames_per_s: medians 1002.0 1002.5" in err
    assert "c1 traced frame_roofline.batch: median 20.0" in err

