"""The comparison that decides ``correct`` fails what it must: the control
(the program's bf16 storage path, below the fp32 the configurations state)
and each fault a cell can have, planted underneath a whole run that skips
only the look for a card. At a size a CPU test run holds; the same control
was read on the card at each cell's own size (``tools/readings.py``)."""
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.result import run_cell  # noqa: E402
from harness.spec import Spec  # noqa: E402

BATCH = ["fullhd-r12.batch16", "fullhd-r4.batch16", "fullhd-r16.batch16", "fullhd-r8.batch16"]
LIVE = ["fullhd-r12.live60", "fullhd-r4.live60"]


def _run(cell, seed=2 ** 31 + 21, precision=None):
    """A whole run at 64x96 with 4 frames a dispatch or 4 streams; the
    window grows until at least 8 frames were compared (the CPU may be
    shared with other tests)."""
    spec = Spec.from_file(REPO / "BENCHMARK.json", cell)
    spec.config.update(height=64, width=96)
    spec.traffic.update(pool_frames=11)
    if "streams" in spec.traffic:
        spec.traffic.update(streams=4)
    else:
        spec.traffic.update(frames_per_dispatch=4)
    for seconds in (0.5, 2.0, 8.0):
        result, _ = run_cell(spec, seed, seconds, False, "cpu", time.perf_counter(),
                             precision=precision)
        if result["checks"]["frames_checked"] >= 8:
            return result
    raise AssertionError(f"{cell}: {result['checks']['frames_checked']} frames compared")


@pytest.mark.parametrize("cell", BATCH + LIVE)
def test_sound_runs_are_correct_and_the_control_is_not(cell):
    sound = _run(cell)
    assert sound["correct"], sound["checks"]
    control = _run(cell, precision="bf16")
    assert not control["correct"], control["checks"]
    assert control["checks"]["mismatch_share"]["value"] > 0.01


@pytest.fixture
def plant(monkeypatch):
    """Patch the program underneath the harness for one test."""
    return monkeypatch


@pytest.mark.parametrize("cell", BATCH)
def test_half_of_each_dispatch_left_out(cell, plant):
    from repro_torch.serving.frames import FrameDenoiseEngine

    step = FrameDenoiseEngine.step

    def half(self, force=False):
        reqs = step(self, force)
        k = len(reqs) // 2
        for lo, hi in zip(reqs[:k], reqs[k:2 * k]):
            hi.result = lo.result  # the second half never computed
        return reqs

    plant.setattr(FrameDenoiseEngine, "step", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", BATCH)
def test_an_answer_altered_where_it_is_produced_batch(cell, plant):
    from repro_torch.serving.frames import FrameDenoiseEngine

    step = FrameDenoiseEngine.step

    def altered(self, force=False):
        reqs = step(self, force)
        for r in reqs:
            r.result = r.result.clone()
            r.result[5, 7] += 3.0
        return reqs

    plant.setattr(FrameDenoiseEngine, "step", altered)
    result = _run(cell)
    assert not result["correct"] and result["checks"]["max_lsb"]["value"] >= 2


@pytest.mark.parametrize("cell", LIVE)
def test_a_step_that_returns_its_state_unchanged(cell, plant):
    import repro_torch.video.session as session

    denoise = session.temporal_denoise

    def stale(frames, carry=None, **kw):
        out, new_carry = denoise(frames, carry=carry, **kw)
        return out, (new_carry if carry is None else carry.clone())

    plant.setattr(session, "temporal_denoise", stale)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", LIVE)
def test_an_answer_altered_where_it_is_produced_live(cell, plant):
    import repro_torch.video.session as session

    denoise = session.temporal_denoise

    def altered(frames, **kw):
        out, new_carry = denoise(frames, **kw)
        out = out.clone()
        out[:, 5, 7] += 3.0
        return out, new_carry

    plant.setattr(session, "temporal_denoise", altered)
    result = _run(cell)
    assert not result["correct"] and result["checks"]["max_lsb"]["value"] >= 2


@pytest.mark.parametrize("cell", LIVE)
def test_two_streams_outputs_swapped(cell, plant):
    from repro_torch.video.session import MultiStreamPacker

    pack = MultiStreamPacker.pack

    def swapped(self, frames, **kw):
        results = pack(self, frames, **kw)
        results[1], results[2] = results[2], results[1]
        return results

    plant.setattr(MultiStreamPacker, "pack", swapped)
    assert not _run(cell)["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", BATCH + LIVE)
def test_each_cell_is_correct_on_the_card_at_its_own_size(cell, card):
    spec = Spec.from_file(REPO / "BENCHMARK.json", cell)
    result, _ = run_cell(spec, 2 ** 31 + 33, 1.0, False, card, time.perf_counter())
    assert result["correct"], result["checks"]
