"""The readers of the program's own spans and counters
(``harness/program.py``): hand-made records and a hand-made trace give
hand-computed values; a run without the program's tracer, without records
in its window, without a trace, or whose buffer dropped records gives
``None``. Then a whole traced run at a tiny size on the CPU."""
import sys
import time
from collections import namedtuple
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import program as program_mod  # noqa: E402
from harness.spec import load_module  # noqa: E402
from harness.trace import TraceSummary  # noqa: E402

Rec = namedtuple("Rec", "name start_ns end_ns parent value")
MS = 1_000_000  # ns
S = 1_000_000_000


def _rec(name, a_ms, b_ms, parent=-1, value=0):
    return Rec(name, S + a_ms * MS, S + b_ms * MS, parent, value)


# a window from 1.0 s to 2.0 s; times below in ms after 1.0 s. The spans
# between a root and its waits or launches are read by no metric: they hold
# the readers to leading every record to its root at any depth.
LIVE = [
    _rec("packer.pack", 100, 200, value=4),              # 0
    _rec("packer.stage", 100, 110, 0),                   # 1
    _rec("temporal.step", 110, 180, 0),                  # 2
    _rec("wait.temporal.alpha", 120, 150, 2),            # 3: 30 ms
    _rec("sync", 120, 120, 3, 1),                        # 4
    _rec("kernel.bg_fused", 160, 160.02, 2),             # 5: 20 us
    _rec("packer.guards", 180, 200, 0),                  # 6
    _rec("wait.packer.carry_rows", 185, 195, 6),         # 7: 10 ms
    _rec("sync", 185, 185, 7, 1),                        # 8
    _rec("packer.pack", 500, 560, value=4),              # 9
    _rec("wait.temporal.alpha", 510, 530, 9),            # 10: 20 ms
    _rec("sync", 510, 510, 10, 1),                       # 11
    _rec("kernel.bg_fused", 540, 540.04, 9),             # 12: 40 us
    _rec("build", 700, 700, value=2),                    # 13
    _rec("packer.pack", -500, -400, value=4),            # 14: before the window
    _rec("wait.temporal.alpha", -490, -410, 14),         # 15
    _rec("sync", -490, -490, 15, 1),                     # 16
    _rec("packer.pack", 950, 1050, value=4),             # 17: past its end
    _rec("sync", 960, 960, 17, 1),                       # 18
]
# device ops: idle 1.13 to 1.16 s (30 ms inside the first pack) and 1.50 to
# 1.55 s (50 ms inside the second)
OPS = [("k", 1.0, 1.13), ("k", 1.16, 1.3), ("copy", 1.25, 1.5), ("k", 1.55, 2.0)]

BATCH = [
    _rec("engine.step", 100, 104, value=16),             # 0
    _rec("engine.stack", 100, 101, 0),                   # 1
    _rec("plan.dispatch", 101, 103.5, 0),                # 2
    _rec("kernel.bg_fused", 101.5, 101.51, 2),           # 3: 10 us
    _rec("plan.quantize", 102, 103, 2),                  # 4
    _rec("engine.results", 103.5, 104, 0),               # 5
    _rec("engine.step", 200, 202, value=16),             # 6
    _rec("kernel.bg_fused", 201, 201.03, 6),             # 7: 30 us
]


BOTH = LIVE + [r._replace(parent=r.parent + len(LIVE) if r.parent >= 0 else -1) for r in BATCH]


class Run:
    def __init__(self, trace=TraceSummary(1.0, 2.0, OPS)):
        self.trace = trace


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "program_" + name.replace(".", "_")).read


@pytest.fixture
def records(monkeypatch):
    """Hand the readers ``records`` (and ``dropped``) as the program's."""
    held = {"records": [], "dropped": 0}
    monkeypatch.setattr(program_mod, "_snapshot", lambda: (held["records"], held["dropped"]))
    return held


def test_live_readers_against_hand_computed_values(records):
    records["records"] = LIVE
    run = Run()
    assert _reader("pack_wait_ms.live")(run) == pytest.approx((40 + 20) / 2)
    assert _reader("pack_work_ms.live")(run) == pytest.approx((60 + 40) / 2)
    assert _reader("syncs_per_pack.live")(run) == pytest.approx(3 / 2)
    assert _reader("launch_host_us")(run) == pytest.approx((20 + 40) / 2)
    assert _reader("program_idle_ms.live")(run) == pytest.approx((30 + 50) / 2)
    assert _reader("window_builds")(run) == 2
    # the batch readers find no dispatch in a live run
    assert _reader("step_work_ms.batch")(run) is None
    assert _reader("syncs_per_dispatch.batch")(run) is None


def test_batch_readers_against_hand_computed_values(records):
    records["records"] = BATCH
    run = Run(TraceSummary(1.0, 2.0, [("k", 1.0, 1.1025), ("k", 1.1035, 2.0)]))
    assert _reader("step_work_ms.batch")(run) == pytest.approx((4 + 2) / 2)
    assert _reader("syncs_per_dispatch.batch")(run) == 0
    assert _reader("launch_host_us")(run) == pytest.approx((10 + 30) / 2)
    assert _reader("program_idle_ms.batch")(run) == pytest.approx((1.0 + 0.0) / 2)
    assert _reader("window_builds")(run) == 0


NEW = ["pack_wait_ms.live", "pack_work_ms.live", "syncs_per_pack.live", "syncs_per_dispatch.batch",
       "step_work_ms.batch", "launch_host_us", "program_idle_ms.batch", "program_idle_ms.live",
       "window_builds"]


@pytest.mark.parametrize("metric", NEW)
def test_none_without_records_or_with_drops(records, metric):
    read = _reader(metric)
    assert read(Run()) is None  # no records at all
    records["records"] = BOTH
    assert read(Run()) is not None
    assert read(Run(None)) is None  # an untraced run
    assert read(Run(TraceSummary(5.0, 6.0, OPS))) is None  # none in the window
    records["dropped"] = 1
    assert read(Run()) is None


@pytest.mark.parametrize("metric", NEW)
def test_none_where_the_program_has_no_tracer(monkeypatch, metric):
    """A commit before the tracer: ``repro_torch.tracing`` does not import.
    The same reader finds the records of a module that is there."""
    read = _reader(metric)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing",
                        SimpleNamespace(records=lambda: BOTH, dropped=lambda: 0))
    assert read(Run()) is not None
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(Run()) is None


def test_a_traced_run_reads_the_programs_spans():
    """A whole traced run of each live and batch cell at 64x96 on the CPU:
    the program's spans lie inside the harness's, and a CPU run waits on no
    card. The device's metrics (launches, idle) have nothing to read here."""
    sys.path.insert(0, str(REPO / "src"))
    from harness.result import run_cell
    from harness.spec import Spec

    for cell in ("fullhd-r12.live60", "fullhd-r4.batch16"):
        spec = Spec.from_file(REPO / "BENCHMARK.json", cell)
        spec.config.update(height=64, width=96)
        spec.traffic.update(pool_frames=11)
        if "streams" in spec.traffic:
            spec.traffic.update(streams=4)
        else:
            spec.traffic.update(frames_per_dispatch=4)
        result, _ = run_cell(spec, 2 ** 31 + 33, 0.5, True, "cpu", time.perf_counter())
        m = {k: v["value"] for k, v in result["metrics"].items()}
        assert result["correct"] and m["window_builds"] == 0
        if cell.endswith("live60"):
            assert m["syncs_per_pack.live"] == 0
            inside = m["pack_wait_ms.live"] + m["pack_work_ms.live"]
            assert 0.5 * m["packer_host_ms.live"] < inside <= m["packer_host_ms.live"]
        else:
            assert m["syncs_per_dispatch.batch"] == 0
            assert 0 < m["step_work_ms.batch"] <= m["engine_host_ms.batch"]
        assert "launch_host_us" not in m and not any(k.startswith("program_idle") for k in m)
