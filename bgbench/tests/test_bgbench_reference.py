"""The benchmark's plain reference against the program's own plain
whole-image filter and staged temporal oracle, at tiny sizes on the CPU.
Only this test imports the program; the reference never does."""
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.frames import make_pool  # noqa: E402
from harness.spec import load_module  # noqa: E402

ref = load_module(BENCH / "references" / "bilateral_grid.py", "bgbench_reference_under_test")
CONFIGS = sorted((BENCH / "configs").glob("*.json"))


def _frames(seed, n, h, w):
    return make_pool(seed, n, h, w, scenes=2, motion_px=2.0, noise_sigma=30.0,
                     device=torch.device("cpu"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
def test_reference_equals_the_programs_plain_filter(path, hw):
    from repro_torch.core.bilateral_grid import BGConfig, bilateral_grid_filter

    cfg = json.loads(path.read_text())
    bg = ref.BG(cfg)
    prog_cfg = BGConfig(r=cfg["r"], sigma_s=cfg["sigma_s"], sigma_r=cfg["sigma_r"])
    frames = _frames(2 ** 31 + 11, 3, *hw)
    got = ref.filter_frames(frames, bg)
    want = torch.stack([bilateral_grid_filter(f, prog_cfg) for f in frames])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    from repro_torch.core.bilateral_grid import grid_shape

    assert ref.grid_shape(*hw, bg) == grid_shape(*hw, prog_cfg)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_configuration_states_the_grid_of_its_frame(path):
    from repro_torch.core.bilateral_grid import BGConfig, grid_shape

    from harness import counts

    cfg = json.loads(path.read_text())
    h, w = cfg["height"], cfg["width"]
    prog_cfg = BGConfig(r=cfg["r"], sigma_s=cfg["sigma_s"], sigma_r=cfg["sigma_r"],
                        intensity_max=cfg["intensity_max"])
    assert tuple(cfg["grid"]) == counts.grid_shape(h, w, cfg) == grid_shape(h, w, prog_cfg)
    assert tuple(cfg["grid"]) == ref.grid_shape(h, w, ref.BG(cfg))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_temporal_replay_equals_the_programs_staged_oracle(path):
    from repro_torch.core.bilateral_grid import BGConfig
    from repro_torch.plan import BGPlan
    from repro_torch.video.session import MultiStreamPacker

    cfg = json.loads(path.read_text())
    prog_cfg = BGConfig(r=cfg["r"], sigma_s=cfg["sigma_s"], sigma_r=cfg["sigma_r"])
    packer = MultiStreamPacker(plan=BGPlan(cfg=prog_cfg, backend="reference", device="cpu"))
    for s in range(2):
        packer.open(s, alpha=0.6)
    replay = ref.TemporalReplay(ref.BG(cfg), 0.6)
    frames = _frames(5, 6, 40, 56)
    for t in range(5):
        pair = frames[[t, t + 1]]
        out = packer.pack({0: pair[0], 1: pair[1]})
        got = replay.step(pair)
        torch.testing.assert_close(got, torch.stack([out[0], out[1]]), rtol=0, atol=1.0)
        assert (got != torch.stack([out[0], out[1]])).float().mean() < 0.01


def test_temporal_replay_differs_from_the_per_frame_filter():
    cfg = json.loads(CONFIGS[0].read_text())
    bg = ref.BG(cfg)
    frames = _frames(9, 4, 48, 64)
    replay = ref.TemporalReplay(bg, 0.6)
    first = replay.step(frames[:1])
    torch.testing.assert_close(first, ref.filter_frames(frames[:1], bg), rtol=0, atol=0)
    for t in range(1, 4):
        out = replay.step(frames[t:t + 1])
    assert (out != ref.filter_frames(frames[3:4], bg)).float().mean() > 0.05


def test_pool_is_seeded_8_bit_and_on_the_asked_device():
    a = _frames(2 ** 31 + 3, 5, 30, 40)
    b = _frames(2 ** 31 + 3, 5, 30, 40)
    assert a.dtype == torch.float32 and a.device.type == "cpu" and a.shape == (5, 30, 40)
    assert torch.equal(a, b) and not torch.equal(a, _frames(4, 5, 30, 40))
    assert torch.equal(a, a.round()) and a.min() >= 0 and a.max() <= 255
    assert len({tuple(f.flatten()[:50].tolist()) for f in a}) == 5
