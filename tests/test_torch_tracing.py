"""The port's own spans and counters (``repro_torch.tracing``): nothing is
recorded without a profiler session; under one, a pack and a dispatch each
give one root with their waits nested under it, on the ``perf_counter``
clock; a full buffer counts what it drops; one build counts once. On the
card, the ``sync`` counter matches every synchronizing call PyTorch reports
on these paths."""
import ctypes
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch
import torch.autograd.profiler as torch_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import BGConfig
from repro_torch.kernels import _build
from repro_torch.plan import BGPlan
from repro_torch.serving.frames import FrameDenoiseEngine, FrameRequest
from repro_torch.video import MultiStreamPacker

CFG = BGConfig(4, 4.0, 60.0)
H, W = 64, 96
WAITS = ["wait.temporal.alpha", "wait.packer.carry_rows"]


def frames(n, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {s: (torch.rand((H, W), generator=g) * 255.0).to(device) for s in range(n)}


def warm_packer(plan, n=4):
    """A packer of ``n`` warm streams, two packs in, so the next pack
    carries every stream's carry."""
    packer = MultiStreamPacker(plan=plan)
    for s in range(n):
        packer.open(s, alpha=0.5)
    for seed in range(2):
        packer.pack(frames(n, seed, plan.device))
    return packer


def warm_engine(plan, n=4):
    eng = FrameDenoiseEngine(plan=plan, max_batch=n)
    for i, f in frames(n, 7, plan.device).items():
        eng.submit(FrameRequest(i, f))
    eng.step()
    return eng


def step(eng, fs):
    for i, f in fs.items():
        eng.submit(FrameRequest(i, f))
    return eng.step()


def tree(recs):
    """``{index: [child names]}`` of the records."""
    kids = {i: [] for i in range(len(recs))}
    for r in recs:
        if r.parent >= 0:
            kids[r.parent].append(r.name)
    return kids


def descendants(recs, root):
    out = []
    for i, r in enumerate(recs):
        j = r.parent
        while j >= 0 and j != root:
            j = recs[j].parent
        if j == root and i != root:
            out.append(i)
    return out


@pytest.fixture
def cpu_plan():
    return BGPlan(CFG, device="cpu")


@pytest.fixture(autouse=True)
def _empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def test_nothing_is_recorded_without_a_profiler(cpu_plan):
    packer = warm_packer(cpu_plan)
    eng = warm_engine(cpu_plan)
    assert not torch_profiler._is_profiler_enabled
    packer.pack(frames(4, 3))
    step(eng, frames(4, 4))
    assert tracing.records() == [] and tracing.dropped() == 0
    # off, every span point hands back one shared object: nothing is allocated
    assert tracing.span("a") is tracing.span("b", 3) is tracing.wait("c", None)


def test_a_pack_and_a_dispatch_nest_under_one_root_each(cpu_plan):
    packer = warm_packer(cpu_plan)
    eng = warm_engine(cpu_plan)
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch_profiler._is_profiler_enabled
        packer.pack(frames(4, 3))
        step(eng, frames(4, 4))
    assert not torch_profiler._is_profiler_enabled
    recs = tracing.records()
    roots = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [(recs[i].name, recs[i].value) for i in roots] == [("packer.pack", 4), ("engine.step", 4)]
    kids = tree(recs)
    pack, eng_root = roots
    # the CPU launches no kernel: a pack's children are its two waits, a
    # dispatch on CPU frames has none
    assert kids[pack] == WAITS
    assert kids[eng_root] == []
    assert [r.name for r in recs if r.name.startswith("wait.")] == WAITS
    # the CPU holds no card to wait for: the sites are spans with no sync count
    assert not [r for r in recs if r.name == "sync"]
    for root in roots:
        a, b = recs[root].start_ns, recs[root].end_ns
        for i in descendants(recs, root):
            r = recs[i]
            assert a <= r.start_ns <= r.end_ns <= b, r
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (p, r)


def test_span_times_are_on_the_perf_counter_clock(cpu_plan):
    packer = warm_packer(cpu_plan)
    eng = warm_engine(cpu_plan)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        packer.pack(frames(4, 3))
        t1 = time.perf_counter()
        step(eng, frames(4, 4))
        t2 = time.perf_counter()
    pack, eng_root = [r for r in tracing.records() if r.parent < 0]
    assert t0 <= pack.start_ns / 1e9 <= pack.end_ns / 1e9 <= t1
    assert t1 <= eng_root.start_ns / 1e9 <= eng_root.end_ns / 1e9 <= t2


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("root", 2):
            for _ in range(3):
                with tracing.span("child"):
                    tracing.count("sync")
    recs = tracing.records()
    assert [r.name for r in recs] == ["root", "child", "sync"]
    assert recs[0].end_ns >= recs[1].end_ns >= recs[2].end_ns == recs[2].start_ns
    assert tracing.dropped() == 4  # two spans and two counts
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_counts_and_spans_keep_to_their_thread():
    barrier = threading.Barrier(2)
    value = {"a": 2, "b": 3}

    def work(name):
        with tracing.span(name):
            barrier.wait(timeout=10)
            tracing.count("build", value[name])
            barrier.wait(timeout=10)

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(n,)) for n in value]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    recs = tracing.records()
    spans = {r.name: i for i, r in enumerate(recs) if r.name in ("a", "b")}
    counts = [r for r in recs if r.name == "build"]
    assert len(counts) == 2 and all(r.parent >= 0 for r in counts)
    # each count lies under the span its own thread had open
    for r in counts:
        assert value[recs[r.parent].name] == r.value
    assert {recs[r.parent].name for r in counts} == set(spans)


def test_a_cache_miss_counts_a_build(cpu_plan):
    packer = warm_packer(cpu_plan)
    with profile(activities=[ProfilerActivity.CPU]):
        packer.pack(frames(4, 3))
        warm = sum(r.value for r in tracing.records() if r.name == "build")
        # a configuration no other test plans: its executable is built here
        plan = BGPlan(BGConfig(4, 4.0, 61.25), device="cpu", batch_tile=3)
        plan(frames(1, 5)[0])
        cold = sum(r.value for r in tracing.records() if r.name == "build")
        # a new tile: a plan variant and its executable, one build
        plan.with_tile(2)(frames(1, 5)[0])
        tile = sum(r.value for r in tracing.records() if r.name == "build")
    assert warm == 0 and cold == 1 and tile == 2


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_the_bf16_route_records_its_two_casts_and_fp32_none(precision):
    """A bf16 dispatch's frames cast to bf16 and its output cast back are two
    ``plan.cast`` spans under the root, each with one ``cast`` count; the
    fp32 route records neither. The same for a pack on the temporal route."""
    plan = BGPlan(CFG, precision=precision, device="cpu")
    eng = warm_engine(plan)
    packer = warm_packer(plan)
    with profile(activities=[ProfilerActivity.CPU]):
        step(eng, frames(4, 4))
        packer.pack(frames(4, 3))
    recs = tracing.records()
    roots = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [recs[i].name for i in roots] == ["engine.step", "packer.pack"]
    n = 2 if precision == "bf16" else 0
    for root in roots:
        spans = [i for i in descendants(recs, root) if recs[i].name == "plan.cast"]
        counts = [recs[i] for i in descendants(recs, root) if recs[i].name == "cast"]
        assert len(spans) == n and sum(c.value for c in counts) == n
        assert [c.parent for c in counts] == spans


def test_a_kernel_library_counts_one_build_a_compile_or_load(monkeypatch, tmp_path):
    """A compile counts 1, a load of a library built before counts 1, a
    library already loaded counts nothing (a stand-in compiler and loader:
    the host has neither nvcc nor a card)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: types.SimpleNamespace(
        bg_blur_error_string=lambda err: b""))

    def builds(fn):
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
        return sum(r.value for r in tracing.records() if r.name == "build")

    assert builds(lambda: _build.load("bg_blur")) == 1  # compiled, then loaded
    assert builds(lambda: _build.load("bg_blur")) == 0  # already loaded
    _build._libs.clear()
    assert builds(lambda: _build.load("bg_blur")) == 1  # loaded from disk


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    """The CUDA device; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _syncs_and_warnings(fn):
    """``(sync counts, synchronizing-call warnings, records)`` of one call
    of ``fn`` under a profiler session, on the card."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    recs = tracing.records()
    syncs = sum(r.value for r in recs if r.name == "sync")
    warned = sum("synchronizing" in str(w.message) for w in caught)
    return syncs, warned, recs


@pytest.mark.gpu
def test_every_synchronizing_call_is_counted_on_the_card(cuda):
    plan = BGPlan(CFG, device=cuda)
    packer = warm_packer(plan)
    eng = warm_engine(plan)
    torch.cuda.synchronize()
    on_card = frames(4, 3, cuda)
    syncs, warned, recs = _syncs_and_warnings(lambda: packer.pack(on_card))
    assert syncs == warned == 2, (syncs, warned)
    waits = [r.name for r in recs if r.name.startswith("wait.")]
    assert waits == ["wait.temporal.alpha", "wait.packer.carry_rows"]
    for i, r in enumerate(recs):
        if r.name == "sync":
            assert recs[r.parent].name.startswith("wait."), r
    launches = [i for i, r in enumerate(recs) if r.name == "kernel.bg_fused"]
    assert launches and all(recs[recs[i].parent].name == "packer.pack" for i in launches)
    assert not [r for r in recs if r.name == "build"]

    on_card = frames(4, 4, cuda)
    syncs, warned, recs = _syncs_and_warnings(lambda: step(eng, on_card))
    assert syncs == warned == 0, (syncs, warned)
    assert [r.name for r in recs if r.parent < 0] == ["engine.step"]
    assert [r.name for r in recs if r.parent == 0] == ["kernel.bg_fused"]

    # host frames: each is a blocking copy onto the card; the stack waits
    host = {i: f.cpu().numpy() for i, f in frames(4, 5).items()}
    syncs, warned, recs = _syncs_and_warnings(lambda: step(eng, host))
    assert syncs == warned == 4, (syncs, warned)
    assert [r.name for r in recs if r.name.startswith("wait.")] == ["wait.engine.stack"]
    host = {s: np.asarray(f) for s, f in host.items()}
    syncs, warned, _ = _syncs_and_warnings(lambda: packer.pack(host))
    assert syncs == warned == 6, (syncs, warned)
