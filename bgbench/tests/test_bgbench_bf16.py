"""The bf16 configuration (``bg-fullhd-r12-bf16``) and its plain reference
(``references/bilateral_grid_bf16.py``), on the CPU at 64x96: the program's
bf16 plan agrees with the reference within the configuration's limits, the
reference keeps the user-facing distance to the exact fp32 filter, and a
whole run of the cell fails what it must: the fp32 path, a lower precision
planted in the program, half of each dispatch left out. ``TemporalReplay``
follows the program's bf16 temporal route stream for stream."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.check import Verdict  # noqa: E402
from harness.drive import bg_config  # noqa: E402
from harness.frames import make_pool  # noqa: E402
from harness.result import run_cell  # noqa: E402
from harness.spec import Spec, load_module  # noqa: E402

CELL = "fullhd-r12-bf16.batch16"
CFG = json.loads((BENCH / "configs" / "bg-fullhd-r12-bf16.json").read_text())
H, W = 64, 96
ref16 = load_module(BENCH / "references" / "bilateral_grid_bf16.py", "bgbench_reference_bf16_test")
ref32 = load_module(BENCH / "references" / "bilateral_grid.py", "bgbench_reference_fp32_test")


def _frames(seed, n):
    return make_pool(seed, n, H, W, scenes=4, motion_px=2.0, noise_sigma=30.0,
                     device=torch.device("cpu"))


def _run(seed=2 ** 31 + 21, precision=None):
    """A whole run of the cell at 64x96, 4 frames a dispatch, as
    ``test_bgbench_control.py`` runs the fp32 cells."""
    spec = Spec.from_file(REPO / "BENCHMARK.json", CELL)
    spec.config.update(height=H, width=W)
    spec.traffic.update(pool_frames=11, frames_per_dispatch=4)
    for seconds in (0.5, 2.0, 8.0):
        result, notes = run_cell(spec, seed, seconds, False, "cpu", time.perf_counter(),
                                 precision=precision)
        if result["checks"]["frames_checked"] >= 8:
            return result, notes
    raise AssertionError(f"{result['checks']['frames_checked']} frames compared")


def test_the_configuration_states_bf16_and_its_own_reference():
    spec = Spec.from_file(REPO / "BENCHMARK.json", CELL)
    assert spec.config["precision"] == "bf16" and spec.config["reference"] == "bilateral_grid_bf16"
    assert spec.traffic["entry"] == "frame_engine_stated"
    r12 = json.loads((BENCH / "configs" / "bg-fullhd-r12.json").read_text())
    differ = {k for k in r12 if r12[k] != CFG.get(k)}
    assert differ - {"limits"} == {"name", "source", "precision", "guarantee", "reference", "assumed"}
    assert CFG["limits"]["max_lsb"] == 1
    assert {k: v for k, v in CFG["assumed"].items() if k != "bf16"} == r12["assumed"]
    batch16 = json.loads((BENCH / "traffic" / "batch16.json").read_text())
    assert dict(spec.traffic, entry="frame_engine") == batch16
    with pytest.raises(ValueError):
        ref16.BG(r12)  # an fp32 configuration is not this reference's


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 31 + 5])
def test_the_programs_bf16_plan_agrees_with_the_bf16_reference(seed):
    """Within the configuration's limits (set from the card's readings at
    the cell's own size): the two differ only where a float32 sum taken in
    another order lands on the other side of a bf16 rounding."""
    from repro_torch.plan import plan_for

    frames = _frames(seed, 8)
    plan = plan_for(bg_config(CFG), H, W, n_frames=8, cache=False, device="cpu", precision="bf16")
    assert plan.precision == "bf16"
    verdict = Verdict(CFG["limits"])
    verdict.add(plan(frames), ref16.filter_frames(frames, ref16.BG(CFG)))
    assert verdict.correct, verdict.numbers()


def test_the_bf16_reference_is_within_3_lsb_of_the_exact_fp32_filter():
    """The user-facing distance of bf16 storage: every quantized pixel
    within 3 LSB of the exact fp32 filter. The output rounded to bf16 before
    it is quantized (spacing 0.5 from 64, 1 from 128) moves about a quarter
    of the pixels by 1 LSB; the rounded grid planes move a pixel by a
    fraction of an LSB more at most."""
    frames = _frames(2 ** 31 + 7, 8)
    got = ref16.filter_frames(frames, ref16.BG(CFG))
    exact = ref32.filter_frames(frames, ref32.BG(CFG))
    diff = (got - exact).abs()
    assert float(diff.max()) <= 3.0
    share = float((diff > 0).float().mean())
    assert 0.05 < share < 0.5, share  # bf16 is not the fp32 filter


def test_a_whole_run_of_the_cell_is_correct_and_runs_bf16():
    result, notes = _run()
    assert result["correct"], result["checks"]
    assert "prec=bf16" in notes[0]


def test_the_fp32_path_fails_the_cell():
    result, notes = _run(precision="fp32")
    assert "prec=fp32" in notes[0]
    assert not result["correct"]
    share = result["checks"]["mismatch_share"]
    assert share["value"] > 10 * share["limit"], share


def _round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """``t`` rounded to ``bits`` explicit mantissa bits (bf16 keeps 7)."""
    m, e = torch.frexp(t)
    scale = float(2 ** (bits + 1))
    return torch.ldexp(torch.round(m * scale) / scale, e)


@pytest.mark.parametrize("planes,bits", [("normalized", 4), ("raw", 3)])
def test_a_lower_precision_in_the_program_fails_the_cell(planes, bits, monkeypatch):
    import importlib

    fused = importlib.import_module("repro_torch.kernels.bg_fused")  # the module, not the wrapper
    name = {"normalized": "grid_normalize", "raw": "bg_create_plain"}[planes]
    original = getattr(fused, name)
    monkeypatch.setattr(fused, name, lambda *a: _round_mantissa(original(*a), bits))
    result, _ = _run()
    assert not result["correct"], result["checks"]


def test_half_of_each_dispatch_left_out_fails_the_cell(monkeypatch):
    from repro_torch.serving.frames import FrameDenoiseEngine

    step = FrameDenoiseEngine.step

    def half(self, force=False):
        reqs = step(self, force)
        k = len(reqs) // 2
        for lo, hi in zip(reqs[:k], reqs[k:2 * k]):
            hi.result = lo.result  # the second half never computed
        return reqs

    monkeypatch.setattr(FrameDenoiseEngine, "step", half)
    result, _ = _run()
    assert not result["correct"], result["checks"]


def test_temporal_replay_follows_the_programs_bf16_temporal_route():
    """Four streams through the packer on a bf16 fused plan (B2-bf16's plain
    version on the CPU), each held to the replay. Within 1 LSB, on at most
    1 % of a frame's pixels: the per-frame filter's float32 ordering
    differences, carried into the blend and the bf16 carry."""
    from repro_torch.plan import BGPlan
    from repro_torch.video.session import MultiStreamPacker

    plan = BGPlan(cfg=bg_config(CFG), backend="fused", precision="bf16", device="cpu")
    packer = MultiStreamPacker(plan=plan)
    for s in range(4):
        packer.open(s, alpha=0.6)
    replay = ref16.TemporalReplay(ref16.BG(CFG), 0.6)
    frames = _frames(2 ** 31 + 13, 9)
    for t in range(5):
        now = frames[t:t + 4]
        out = packer.pack({s: now[s] for s in range(4)})
        got = torch.stack([out[s] for s in range(4)])
        want = replay.step(now)
        diff = (got - want).abs()
        assert float(diff.max()) <= 1.0, t
        assert float((diff > 0).flatten(1).float().mean(1).max()) < 0.01, t
    assert replay.carry is not None
    assert torch.equal(replay.carry, replay.carry.to(torch.bfloat16).to(torch.float32))


def test_temporal_replay_starts_as_the_per_frame_filter_and_then_departs():
    bg = ref16.BG(CFG)
    frames = _frames(2 ** 31 + 17, 4)
    replay = ref16.TemporalReplay(bg, 0.6)
    torch.testing.assert_close(replay.step(frames[:1]), ref16.filter_frames(frames[:1], bg),
                               rtol=0, atol=0)
    for t in range(1, 4):
        out = replay.step(frames[t:t + 1])
    assert (out != ref16.filter_frames(frames[3:4], bg)).float().mean() > 0.05


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "bf16_" + name.replace(".", "_")).read


# device ops of a traced window from 1.0 s to 2.0 s over 32 frames, as torch
# 2.11 names them on the card (shortened): the kernel, the two casts, the
# engine's stack and a sampled output's copy
OPS = [("void (anonymous namespace)::bg_fused_streamed_kernel<2, __nv_bfloat16>(...)", 1.0, 1.0006),
       ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda"
        "(at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >(...)", 1.1, 1.1002),
       ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::"
        "TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() const::"
        "{lambda(float)#1}, ..., at::native::memory::LoadWithCast<1>, at::native::memory::"
        "StoreWithCast<1> >(...)", 1.2, 1.2001),
       ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<...>(...)", 1.3, 1.3002),
       ("Memcpy DtoD (Device -> Device)", 1.4, 1.41)]


def _traced_run(ops=OPS):
    from harness.drive import Run
    from harness.trace import TraceSummary

    run = Run(config=dict(CFG), traffic={}, completed=32)
    run.span("engine", 1.0, 1.5)
    run.trace = TraceSummary(1.0, 2.0, ops)
    return run


def test_the_device_readers_against_hand_computed_values():
    from harness.counts import FP32_FLOPS_PER_S, HBM_BYTES_PER_S, fused_work, frame_bound_s

    run = _traced_run()
    assert _reader("bf16_cast_us.batch")(run) == pytest.approx(1e6 * 0.0003 / 32)
    nbytes, flops = fused_work(1, 1080, 1920, CFG, esize=2)
    assert nbytes == 1080 * 1920 * 4 + (1920 + 12) * 4  # a bf16 frame in and out, the fractions
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
    assert _reader("bf16_fused_roofline.batch")(run) == pytest.approx(100 * bound / (0.0006 / 32))
    busy = 0.0006 + 0.0002 + 0.0001 + 0.0002 + 0.01
    assert _reader("bf16_frame_roofline.batch")(run) == pytest.approx(
        100 * frame_bound_s(CFG, temporal=False) / (busy / 32))
    for name, ops in (("bf16_cast_us.batch", OPS[3:]), ("bf16_fused_roofline.batch", OPS[1:]),
                      ("bf16_frame_roofline.batch", [])):
        assert _reader(name)(_traced_run(ops)) is None  # none of the ops it reads
        untraced = _traced_run()
        untraced.trace = None
        assert _reader(name)(untraced) is None


def test_casts_per_dispatch_counts_under_the_steps_in_the_window(monkeypatch):
    from collections import namedtuple

    from harness import program

    Rec = namedtuple("Rec", "name start_ns end_ns parent value")
    ms = 1_000_000
    s = 1_000_000_000
    recs = [Rec("engine.step", s + 100 * ms, s + 104 * ms, -1, 16),  # 0
            Rec("plan.cast", s + 101 * ms, s + 102 * ms, 0, 0),      # 1
            Rec("cast", s + 101 * ms, s + 101 * ms, 1, 1),           # 2
            Rec("plan.cast", s + 103 * ms, s + 104 * ms, 0, 0),      # 3
            Rec("cast", s + 103 * ms, s + 103 * ms, 3, 1),           # 4
            Rec("engine.step", s + 200 * ms, s + 204 * ms, -1, 16),  # 5: one cast only
            Rec("plan.cast", s + 201 * ms, s + 202 * ms, 5, 0),      # 6
            Rec("cast", s + 201 * ms, s + 201 * ms, 6, 1),           # 7
            Rec("engine.step", s - 9 * ms, s - 5 * ms, -1, 16),      # 8: before the window
            Rec("cast", s - 8 * ms, s - 8 * ms, 8, 1)]               # 9
    held = {"snap": (recs, 0)}
    monkeypatch.setattr(program, "_snapshot", lambda: held["snap"])
    read = _reader("casts_per_dispatch.batch")
    assert read(_traced_run()) == pytest.approx(3 / 2)
    held["snap"] = ([r._replace(name="sync") if r.name == "cast" else r for r in recs], 0)
    # a program without the counter
    assert read(_traced_run()) is None
    held["snap"] = (recs, 1)  # records dropped
    assert read(_traced_run()) is None
    held["snap"] = None  # a program without the tracer
    assert read(_traced_run()) is None


def test_a_traced_run_of_the_cell_counts_two_casts_a_dispatch():
    spec = Spec.from_file(REPO / "BENCHMARK.json", CELL)
    spec.config.update(height=H, width=W)
    spec.traffic.update(pool_frames=11, frames_per_dispatch=4)
    result, _ = run_cell(spec, 2 ** 31 + 23, 0.5, True, "cpu", time.perf_counter())
    assert result["metrics"]["casts_per_dispatch.batch"]["value"] == 2.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_the_cell_is_correct_on_the_card_at_its_own_size(card):
    spec = Spec.from_file(REPO / "BENCHMARK.json", CELL)
    result, notes = run_cell(spec, 2 ** 31 + 33, 1.0, False, card, time.perf_counter())
    assert result["correct"], result["checks"]
    assert "prec=bf16" in notes[0]
