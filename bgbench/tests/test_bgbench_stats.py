"""The harness's arithmetic: the p95 over every frame, the union of the
device's busy intervals and its idle gaps, the seeded sample, and the
counted bounds of the yardstick."""
import statistics
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.counts import frame_bound_s, fused_work, grid_shape  # noqa: E402
from harness.stats import Reservoir, gaps, percentile, union_length  # noqa: E402
from harness.spec import load_module  # noqa: E402

R12 = {"r": 12, "sigma_s": 8.0, "sigma_r": 70.0, "intensity_max": 255.0, "height": 1080, "width": 1920}
R4 = dict(R12, r=4)


def test_p95_is_over_every_frame_nearest_rank():
    # 100 packs of 3 frames each; the tail frames are counted one by one
    lat = [float(v) for v in range(1, 101) for _ in range(3)]
    assert percentile(lat, 95) == 95.0
    assert percentile([5.0], 95) == 5.0
    vals = [float(v) for v in range(1, 21)]
    assert percentile(vals, 95) == 19.0 and percentile(vals, 100) == 20.0
    assert percentile(list(reversed(vals)), 50) == 10.0
    with pytest.raises(ValueError):
        percentile([], 95)


def test_p95_reader_reads_every_frame_of_the_window():
    reader = load_module(BENCH / "metrics" / "frame_ms_p95.py", "p95_reader").read

    class Run:
        latencies_ms = [1.0] * 940 + [50.0] * 60

    assert reader(Run()) == 50.0
    Run.latencies_ms = [1.0] * 960 + [50.0] * 40
    assert reader(Run()) == 1.0
    Run.latencies_ms = []
    assert reader(Run()) is None


def test_union_and_gaps_of_device_intervals():
    ivs = [(1.0, 2.0), (1.5, 3.0), (4.0, 5.0), (4.2, 4.4), (9.0, 12.0), (-1.0, 0.5)]
    assert union_length(ivs, 0.0, 10.0) == pytest.approx(0.5 + 2.0 + 1.0 + 1.0)
    assert gaps(ivs, 0.0, 10.0) == [(0.5, 1.0), (3.0, 4.0), (5.0, 9.0)]
    assert gaps([], 0.0, 2.0) == [(0.0, 2.0)]
    assert union_length([(0.0, 1.0), (1.0, 2.0)], 0.0, 2.0) == 2.0


def test_idle_share_and_gap_labels():
    from harness.trace import TraceSummary

    tr = TraceSummary(0.0, 10.0, [("k", 0.0, 4.0), ("k", 5.0, 9.0), ("copy", 8.0, 9.5)])
    assert tr.busy_s == pytest.approx(8.5)
    assert tr.top_ops()[0] == ["k", pytest.approx(8.0)]
    spans = {"wait": [(4.2, 4.9)], "sleep": [(9.4, 10.0)]}
    assert tr.idle_gaps(spans) == [["wait", pytest.approx(1.0)], ["sleep", pytest.approx(0.5)]]
    idle = load_module(BENCH / "metrics" / "device_idle_share.batch.py", "idle_reader").read

    class Run:
        trace = tr
        spans = {"engine": [(0.0, 1.0)]}

    assert idle(Run()) == pytest.approx(15.0)


def test_reservoir_is_seeded_and_uniform():
    def draw(seed, n=2000, k=8):
        res = Reservoir(k, seed)
        for i in range(n):
            slot = res.offer(i)
            if slot is not None:
                res.put(slot, i)
        return res.items

    assert draw(2 ** 31 + 7) == draw(2 ** 31 + 7)
    assert draw(1) != draw(2)
    means = [statistics.mean(draw(s)) for s in range(200)]
    assert 850 < statistics.mean(means) < 1150


def test_frozen_counts_are_the_configurations_numbers():
    assert grid_shape(1080, 1920, R12) == (92, 162, 4)
    assert grid_shape(1080, 1920, R4) == (272, 482, 9)
    assert fused_work(1, 1080, 1920, R12)[0] == 16_596_528
    assert fused_work(1, 1080, 1920, R12, temporal=True)[0] == 17_550_388
    assert fused_work(1, 1080, 1920, R4)[0] == 16_596_496
    assert fused_work(1, 1080, 1920, R4, temporal=True)[0] == 35_475_476
    assert frame_bound_s(R12, False) == pytest.approx(4.954e-6, rel=1e-3)
    assert frame_bound_s(R12, True) == pytest.approx(5.239e-6, rel=1e-3)
    assert frame_bound_s(R4, False) == pytest.approx(4.954e-6, rel=1e-3)
    assert frame_bound_s(R4, True) == pytest.approx(10.590e-6, rel=1e-3)
    for cfg in (R12, R4):  # every cell is bound by bytes: operations take 1.0 to 1.7 us
        for temporal in (False, True):
            flops = fused_work(1, 1080, 1920, cfg, temporal=temporal)[1]
            assert 1.0e-6 < flops / 67e12 < 1.7e-6


def test_frozen_counts_equal_the_programs_at_this_commit():
    """The copy was taken from ``repro_torch.plan.fused_work``; a later change
    to the program does not move the yardstick, this test only records that
    they agreed when the copy was made."""
    plan = pytest.importorskip("repro_torch.plan")
    from repro_torch.core.bilateral_grid import BGConfig

    for cfg in (R12, R4):
        bg = BGConfig(r=cfg["r"], sigma_s=cfg["sigma_s"], sigma_r=cfg["sigma_r"])
        for b in (1, 16):
            for temporal in (False, True):
                assert fused_work(b, 1080, 1920, cfg, temporal=temporal) == plan.fused_work(
                    b, 1080, 1920, bg, temporal=temporal)
