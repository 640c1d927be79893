"""The port's plan selection (``repro_torch.plan``: ``plan_for``, the H100
cost model, the fallback ladder, provenance, the dispatch hook) against the
JAX package's, on the CPU at small sizes.

Pinned ``plan_for`` calls give the JAX package's payload and hash; the
fallback ladders have the same rungs; the provenance labels and precision
modes mean the same. The JAX package's geometry and cost cases (VMEM
budgets of the TPU) are restated for the H100 rule: a block's shared memory
does not grow with the batch, so the tile is the pack, capped at 64, and the
rule raises where the kernels' geometry raises. An autouse fixture points
the port's default plan cache at a file under ``tmp_path``.
"""
import numpy as np
import pytest
import torch

from repro.core import BGConfig as JBGConfig
from repro.plan import BGPlan as JBGPlan
from repro.plan import plan_for as jplan_for
from repro_torch.core import BGConfig, synthetic_image_np
from repro_torch.plan import (
    MAX_AUTO_TILE,
    BGPlan,
    auto_batch_tile,
    fused_work,
    plan_cost,
    plan_cost_breakdown,
    plan_cost_measured,
    plan_for,
    set_dispatch_hook,
    staged_work,
)
from repro_torch.plan_cache import CACHE_ENV_VAR, PlanCache, set_default_cache, workload_key
from repro_torch.video import MultiStreamPacker

ARGS = (4, 3.0, 50.0)
CFG, JCFG = BGConfig(*ARGS), JBGConfig(*ARGS)
PAPER, JPAPER = BGConfig(12, 8.0, 70.0), JBGConfig(12, 8.0, 70.0)
H, W = 19, 26  # ragged against r on both axes


@pytest.fixture(autouse=True)
def _port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV_VAR, str(tmp_path / "plan_cache.json"))
    set_default_cache(None)
    yield
    set_default_cache(None)


def frames_np(b, h=H, w=W, seed=0):
    clean = np.stack([synthetic_image_np(h, w, seed=seed + i) for i in range(b)])
    noise = np.random.default_rng(seed + 50).normal(0.0, 30.0, clean.shape)
    return np.clip(np.floor(clean + noise + 0.5), 0.0, 255.0).astype(np.float32)


def _pf(cfg=CFG, h=H, w=W, **kw):
    return plan_for(cfg, h, w, device="cpu", **kw)


# ------------------------------------------------------ against the JAX package
PINNED = [
    dict(backend="fused", batch_tile=4),
    dict(backend="fused", batch_tile=2, precision="bf16"),
    dict(backend="fused", batch_tile=3, quantize_output=False),
    dict(backend="fused_streamed", batch_tile=8),
    dict(backend="fused_streamed", batch_tile=1, precision="bf16"),
    dict(backend="fused", batch_tile=4, temporal=True),
    dict(backend="fused", batch_tile=3, temporal=True, precision="bf16"),
    dict(backend="staged"),
    dict(backend="staged", precision="auto"),
    dict(backend="reference"),
    dict(backend="reference", precision="fp32", n_frames=5),
    dict(backend="reference", temporal=True, precision="bf16"),
    dict(stream_input=True, batch_tile=2),
    dict(stream_input=False, batch_tile=6, precision="fp32"),
]


@pytest.mark.parametrize("kw", PINNED, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_pinned_plan_for_matches_jax_payload_and_hash(kw):
    """Every pinned call gives the JAX package's version-1 payload and its
    plan hash, character for character, with provenance "explicit"."""
    mine = _pf(sharded=False, **kw)
    theirs = jplan_for(JCFG, H, W, sharded=False, **kw)
    assert mine.to_json() == theirs.to_json()
    assert mine.plan_hash() == theirs.plan_hash()
    assert mine.provenance == theirs.provenance == "explicit"
    assert mine.device == torch.device("cpu")


LADDER_PLANS = [
    dict(backend="fused_streamed", batch_tile=4),
    dict(backend="fused_streamed", batch_tile=2, precision="bf16"),
    dict(backend="fused", batch_tile=3),
    dict(backend="fused", batch_tile=4, temporal=True),
    dict(backend="fused", temporal=True, precision="bf16"),
    dict(backend="staged"),
    dict(backend="reference"),
    dict(backend="reference", temporal=True, precision="bf16"),
]


@pytest.mark.parametrize("kw", LADDER_PLANS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_fallback_ladder_matches_jax(kw):
    """The same rungs as the JAX package's ``fallback_ladder`` (backend,
    temporal, precision, tile and payload), each on this plan's device."""
    mine = BGPlan(CFG, device="cpu", **kw).fallback_ladder()
    theirs = JBGPlan(cfg=JCFG, **kw).fallback_ladder()
    assert [p.to_json() for p in mine] == [p.to_json() for p in theirs]
    assert [p.plan_hash() for p in mine] == [p.plan_hash() for p in theirs]
    assert all(p.device == torch.device("cpu") for p in mine)
    assert mine[-1].backend == "reference" and mine[-1].batch_tile is None
    assert all(p.temporal == mine[0].temporal and p.precision == mine[0].precision for p in mine)


@pytest.mark.parametrize("kw", LADDER_PLANS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_card_ladder_ends_at_the_last_kernel_rung(kw, monkeypatch):
    """On a card the ladder is the CPU's without its ``reference`` rung:
    plain PyTorch never answers for a kernel there (``fused_streamed ->
    fused``; ``fused``, ``staged`` and ``reference`` alone). The card is
    stood in for by letting ``BGPlan`` keep a CUDA device on this host."""
    import repro_torch.plan as P

    monkeypatch.setattr(P, "resolve_device", lambda d: torch.device("cpu" if d is None else d))
    cuda = torch.device("cuda", 0)
    mine = BGPlan(CFG, device=cuda, **kw).fallback_ladder()
    on_cpu = BGPlan(CFG, device="cpu", **kw).fallback_ladder()
    kernel_rungs = [p for p in on_cpu if p.backend != "reference"] or [on_cpu[0]]
    assert [p.to_json() for p in mine] == [p.to_json() for p in kernel_rungs]
    assert all(p.device == cuda for p in mine)
    assert all(p.backend != "reference" for p in mine[1:])  # never a lower rung


def test_plan_provenance_labels():
    """The JAX package's labels (tests/test_plan.py:699), in both packages."""
    assert BGPlan(CFG, device="cpu").provenance == JBGPlan(cfg=JCFG).provenance == "default"
    tuned = _pf(h=60, w=96, n_frames=8, cache=False)
    jtuned = jplan_for(JCFG, 60, 96, n_frames=8, sharded=False, cache=False)
    assert tuned.provenance == jtuned.provenance == "model"
    pinned = _pf(h=60, w=96, backend="fused", batch_tile=4)
    assert pinned.provenance == "explicit"
    assert "src=model" in tuned.describe() and "src=explicit" in pinned.describe()
    # informational: no part of equality or the hash
    assert tuned.with_options() == tuned
    assert BGPlan(CFG, backend="fused", batch_tile=8, device="cpu").plan_hash() == tuned.plan_hash()
    # the H100 model picks what the JAX model picks at this small geometry
    assert tuned.to_json() == jtuned.to_json()


def test_plan_for_cache_provenance(tmp_path):
    pc = PlanCache(str(tmp_path / "c.json"))
    pc.record(workload_key(CFG, 60, 96, 8, False, 1, device="cpu"),
              BGPlan(CFG, backend="fused_streamed", batch_tile=2, device="cpu"))
    hit = _pf(h=60, w=96, n_frames=8, cache=pc)
    assert hit.provenance == "cache" and "src=cache" in hit.describe()
    assert (hit.backend, hit.batch_tile) == ("fused_streamed", 2)


def test_plan_for_precision_modes():
    """The modes of tests/test_plan.py:644: ``None`` keeps fp32, a pinned
    bf16 is honored by the model, ``"auto"`` ranks both storage types (on the
    H100 model the plan's two casts make bf16 dearer at this geometry, where
    the JAX model's halved VMEM traffic made it cheaper), ``"auto"`` on a
    pinned non-fused backend stays fp32, and an unknown name raises."""
    p = _pf(h=60, w=96, n_frames=8, cache=False)
    assert p.precision == "fp32"
    assert jplan_for(JCFG, 60, 96, n_frames=8, sharded=False, cache=False).precision == "fp32"
    p16 = _pf(h=60, w=96, n_frames=8, cache=False, precision="bf16")
    assert p16.precision == "bf16" and p16.provenance == "model"
    pa = _pf(h=60, w=96, n_frames=8, cache=False, precision="auto")
    assert plan_cost(pa, 60, 96, 8) == min(plan_cost(p, 60, 96, 8), plan_cost(p16, 60, 96, 8))
    assert pa.precision == "fp32"
    pr = _pf(h=60, w=96, backend="staged", cache=False, precision="auto")
    assert pr.precision == "fp32"
    with pytest.raises(ValueError, match="precision"):
        _pf(h=60, w=96, precision="fp64")


def test_packer_asks_plan_for_tile():
    """The packer takes its tile from the plan (tests/test_plan.py:232): a
    plan_for plan tiles the whole pack, and a packer on it equals a packer
    on the untiled plan bit for bit (results do not depend on the tile)."""
    n = 3
    plan = _pf(n_frames=n, temporal=True)
    assert plan.batch_tile == n and plan.tile_for(n) == n
    plain = MultiStreamPacker(plan=BGPlan(CFG, device="cpu"))
    tuned = MultiStreamPacker(plan=plan)
    for p in (plain, tuned):
        for s in range(n):
            p.open(s, alpha=0.5)
    for t in range(3):
        frames = {s: frames_np(1, seed=100 * t + s)[0] for s in range(n)}
        out_a, out_b = plain.pack(frames), tuned.pack(frames)
        for s in range(n):
            assert torch.equal(out_a[s], out_b[s])


def test_pack_with_an_alternate_plan():
    """``pack(plan=)`` dispatches a ladder rung for one pack; a rung on
    another device or storage type is refused."""
    packer = MultiStreamPacker(plan=BGPlan(CFG, device="cpu"))
    for s in range(2):
        packer.open(s, alpha=0.6)
    rung = packer.plan.fallback_ladder()[-1]
    out = packer.pack({s: frames_np(1, seed=s)[0] for s in range(2)}, plan=rung)
    assert all(torch.isfinite(o).all() for o in out.values())
    assert all(packer.sessions[s].carry is not None for s in range(2))
    with pytest.raises(ValueError, match="precision"):
        packer.pack({0: frames_np(1)[0]}, plan=packer.plan.with_options(precision="bf16"))


def test_auto_tuner_geometry_rules():
    """tests/test_plan.py:328 for the H100: full HD at the paper radius
    streams (B3 reads each frame once), small frames and temporal plans stay
    on B1; the tile is the pack, capped at 64, whatever the frame size."""
    hd = _pf(PAPER, 1080, 1920, sharded=False, cache=False)
    assert hd.backend == "fused_streamed"
    assert jplan_for(JPAPER, 1080, 1920, sharded=False, cache=False).backend == "fused_streamed"
    assert _pf(h=96, w=128, sharded=False, cache=False).backend == "fused"
    assert _pf(PAPER, 1080, 1920, temporal=True, sharded=False, cache=False).backend == "fused"
    assert auto_batch_tile(CFG, 60, 96) == auto_batch_tile(PAPER, 1080, 1920) == MAX_AUTO_TILE == 64
    assert auto_batch_tile(CFG, 60, 96, n_frames=3) == 3
    assert auto_batch_tile(CFG, 60, 96, n_frames=64, mesh_size=8) == 8
    assert auto_batch_tile(PAPER, 1080, 1920, n_frames=200) == 64


def test_plan_for_fills_concrete_tile():
    """tests/test_plan.py:353: plan_for pins a concrete tile; a plan with
    ``batch_tile=None`` answers with the whole pack (one launch)."""
    p = _pf(h=60, w=96, n_frames=16, sharded=False, cache=False)
    assert p.batch_tile == 16 and p.backend == "fused"
    assert p.tile_for(16) == 16 and p.tile_for(5) == 5
    assert p.with_tile(5).batch_tile == 5 and p.with_tile(16) is p
    assert BGPlan(CFG, backend="fused", device="cpu").tile_for(64) == 64


def test_auto_batch_tile_edges():
    """tests/test_plan.py:548 for the H100: no memory rule cuts the tile;
    the mesh share rounds up; a frame whose one stripe of one cell does not
    fit a block's shared memory raises, as the kernels' geometry does."""
    huge = BGConfig(r=16, sigma_s=2.0, sigma_r=10.0)
    assert auto_batch_tile(huge, 4320, 7680) == MAX_AUTO_TILE
    assert auto_batch_tile(CFG, 60, 96, n_frames=7, mesh_size=2) == 4
    assert auto_batch_tile(CFG, 60, 96, n_frames=64, mesh_size=8) == 8
    deep = BGConfig(r=4, sigma_s=4.0, sigma_r=2.0)  # gz = 129 z bins
    for kw in ({}, {"temporal": True}, {"stream_input": True}):
        with pytest.raises(ValueError, match="bytes of shared memory"):
            auto_batch_tile(deep, 60, 96, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        _pf(deep, 60, 96, n_frames=4, cache=False)
    # bf16 halves the frame rows a block stages: no larger tile (no budget)
    assert auto_batch_tile(PAPER, 1080, 1920, precision="bf16") == MAX_AUTO_TILE


def test_plan_cost_monotonicity():
    """tests/test_plan.py:497 on the H100 model."""
    p = BGPlan(CFG, backend="fused", batch_tile=4, device="cpu")
    assert plan_cost(p, 60, 96, 8) < plan_cost(p, 120, 192, 8)
    assert plan_cost(p, 60, 96, 8) < plan_cost(p, 60, 96, 32)
    costs = [plan_cost(BGPlan(CFG, backend="fused", batch_tile=t, device="cpu"), 60, 96, 16)
             for t in (1, 2, 4, 8, 16)]
    assert all(a > b for a, b in zip(costs, costs[1:]))  # fewer launches
    # B3 reads each frame once: it wins at full HD at the paper radius and
    # loses at small frames, where its costlier launch dominates
    fused_hd = BGPlan(PAPER, backend="fused", batch_tile=2, device="cpu")
    streamed_hd = BGPlan(PAPER, backend="fused_streamed", batch_tile=2, device="cpu")
    assert plan_cost(streamed_hd, 1080, 1920, 4) < plan_cost(fused_hd, 1080, 1920, 4)
    fused_sm = BGPlan(CFG, backend="fused", batch_tile=4, device="cpu")
    streamed_sm = BGPlan(CFG, backend="fused_streamed", batch_tile=4, device="cpu")
    assert plan_cost(fused_sm, 60, 96, 8) < plan_cost(streamed_sm, 60, 96, 8)
    temporal = BGPlan(CFG, backend="fused", temporal=True, batch_tile=4, device="cpu")
    assert plan_cost(temporal, 60, 96, 8) > plan_cost(fused_sm, 60, 96, 8)
    bd = plan_cost_breakdown(fused_sm, 60, 96, 8)
    assert bd["total_s"] >= bd["bound_s"] > 0
    assert bd["bound_s"] == max(bd["compute_s"], bd["memory_s"])
    assert bd["flops"] > 0 and bd["hbm_bytes"] > 0 and bd["steps"] == 2
    # the reference backend is never ranked: the model does not cost it
    with pytest.raises(ValueError, match="never ranked"):
        plan_cost(BGPlan(CFG, backend="reference", device="cpu"), 60, 96, 8)
    # bf16 storage: half the kernel's bytes, plus the plan's two casts
    f16 = BGPlan(CFG, backend="fused", batch_tile=4, precision="bf16", device="cpu")
    b32, b16 = plan_cost_breakdown(fused_sm, 60, 96, 8), plan_cost_breakdown(f16, 60, 96, 8)
    assert b16["hbm_bytes"] - b32["hbm_bytes"] == 8 * 60 * 96 * (12 - 6)
    # staged: four launches (B4, B5, the normalization, B6) whatever the pack
    assert plan_cost_breakdown(BGPlan(CFG, backend="staged", device="cpu"), 60, 96, 8)["steps"] == 4


def test_model_ranks_full_hd_as_the_card_measured():
    """At PAPER_DEFAULT full HD the model picks what the card measured
    where the card's margin is above its run-to-run spread (chip_smoke.py's
    plan_sweep, NVIDIA H100 80GB HBM3, 700.00 W): B3 for packs of 4 and 8
    (4 % and 6 % ahead of B1), the whole pack in one launch, fp32 (bf16
    22 % to 29 % behind). At one frame B3 led B1 by 0.4 % in one run and
    2.7 % in the next, inside the spread, so only the tile and the
    precision are held there."""
    for n, backends in ((1, ("fused", "fused_streamed")), (4, ("fused_streamed",)), (8, ("fused_streamed",))):
        p = _pf(PAPER, 1080, 1920, n_frames=n, cache=False, precision="auto")
        assert p.backend in backends and (p.batch_tile, p.precision) == (n, "fp32")


def test_fused_work_is_the_smoke_bound():
    """``chip_smoke.py``'s kernel bounds take their counts from the cost
    model's functions, so the two cannot drift apart."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.core.bilateral_grid import grid_shape

    for esize in (4, 2):
        assert smoke.bg_fused_bound(8, 1080, 1920, PAPER, grid_shape, esize)[2:] == \
            fused_work(8, 1080, 1920, PAPER, esize)
        assert smoke.bg_fused_temporal_bound(8, 1080, 1920, PAPER, grid_shape, esize)[2:] == \
            fused_work(8, 1080, 1920, PAPER, esize, temporal=True)
    bounds = smoke.staged_bounds(8, 1080, 1920, PAPER, grid_shape)
    assert {k: v[2:] for k, v in bounds.items()} == staged_work(8, 1080, 1920, PAPER)
    gx, gy, gz = grid_shape(1080, 1920, PAPER)
    assert fused_work(1, 1080, 1920, PAPER) == (1080 * 1920 * 8 + (1920 + 12) * 4,
                                                32 * 1080 * 1920 + 33 * gx * gy * gz)


def test_no_tpu_constant_in_the_cost_model():
    import repro_torch.plan as P

    for name in ("VMEM_STEP_BUDGET_BYTES", "STREAM_INPUT_THRESHOLD_BYTES", "DISPATCH_OVERHEAD_S", "STEP_OVERHEAD_S",
                 "STREAM_DMA_OVERHEAD_S", "step_bytes_per_frame", "auto_stream_input",
                 "plan_cost_hlo"):
        assert not hasattr(P, name), name
    assert (P.HBM_BYTES_PER_S, P.FP32_FLOPS_PER_S) == (3.35e12, 67e12)


def test_plan_for_is_single_device():
    with pytest.raises(NotImplementedError, match="mesh"):
        _pf(n_frames=4, sharded=True)
    with pytest.raises(NotImplementedError, match="mesh"):
        _pf(n_frames=4, mesh=object())
    # the JAX package's error first for a backend that does not shard
    with pytest.raises(ValueError, match="mesh-capable"):
        _pf(backend="reference", sharded=True)
    assert _pf(backend="reference").to_json()["mesh_size"] == 1


def test_dispatch_hook_fires_and_aborts():
    plan = BGPlan(CFG, backend="reference", device="cpu")
    frames = frames_np(2)
    seen = []
    record = seen.append
    assert set_dispatch_hook(record) is None
    try:
        out = plan(frames)
        assert seen == [plan] and out.shape == frames.shape

        def refuse(p):
            raise RuntimeError(f"refused {p.backend}")

        assert set_dispatch_hook(refuse) is record
        with pytest.raises(RuntimeError, match="refused reference"):
            plan(frames)
    finally:
        set_dispatch_hook(None)
    assert len(seen) == 1
    plan(frames)  # cleared: dispatches again
    assert len(seen) == 1


def test_plan_cost_measured_on_cpu():
    frames = torch.from_numpy(frames_np(2))
    for plan in (BGPlan(CFG, backend="fused", device="cpu"),
                 BGPlan(CFG, backend="fused", temporal=True, device="cpu")):
        assert 0.0 < plan_cost_measured(plan, H, W, 2, reps=2, frames=frames) < 60.0
    assert plan_cost_measured(BGPlan(CFG, device="cpu"), H, W, 1, reps=1, warmup=0) > 0.0
