"""The port's dry-run and roofline tooling (``repro_torch.launch.{specs,
hlo_cost,hlo_analysis,dryrun,roofline}``) against the JAX package's, on the
CPU.

Where the JAX package's code runs green on this host, the port is held to
it: ``effective_accum`` / ``shape_cfg`` exactly, ``input_specs`` (shapes;
dtypes, with JAX's int32 ids int64) and ``batch_logical_axes`` for every
arch and shape, ``_shard_tree``'s batch and cache specs on the 16x16 and
2x16x16 meshes (JAX in a subprocess with 512 forced host devices), the skip
records, and the renderers' strings for the same records. Where JAX's own
tests fail on this host (its mesh paths: ``test_mini_dryrun_cell_with_roofline``
and ``test_collectives_counted_with_ring_model``), the port is held to hand
counts: the counting twins of ``tests/test_hlo_cost.py`` (loops, nested
loops, a batched einsum, a slice per step), the ring model's bytes on an
8-rank fake group, a DTensor product counted at its local shard only, and
the mini cell (smoke gemma2-9b, ``grad_accum=2``, a (2, 4) mesh) with its
argument bytes counted by hand. The cases that need a process group run in
``tests/torch_dryrun_cases.py``, a process of their own.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import repro_torch.configs.registry as TR
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun as TD
from repro_torch.launch import roofline as TRoof
from repro_torch.launch import specs as TS
from repro_torch.launch.hlo_analysis import HBM_BW, HW, NVLINK_BW, PEAK_FLOPS, roofline_terms
from repro_torch.launch.hlo_cost import HloCost, analyze_step
from repro_torch.sharding.partitioning import DEFAULT_RULES, MeshShape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": (("data", "model"), (16, 16)), "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _paths(tree, prefix=""):
    """``[(path, leaf)]`` of a nested dict in sorted key order (JAX's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def _norm(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("arch", TR.ARCHS)
def test_accum_and_shape_cfg_equal_jax(arch):
    import repro.configs.registry as JR
    import repro.launch.specs as JS
    from repro.configs.base import SHAPES as JSHAPES

    for name in SHAPES:
        for dp in (16, 32):
            mine = TS.shape_cfg(TR.get_config(arch), SHAPES[name], dp)
            theirs = JS.shape_cfg(JR.get_config(arch), JSHAPES[name], dp)
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), (arch, name, dp)
            for requested in (1, 2, 3, 4, 8):
                assert TS.effective_accum(requested, SHAPES[name].global_batch, dp) == JS.effective_accum(
                    requested, JSHAPES[name].global_batch, dp)


@pytest.mark.parametrize("arch", TR.ARCHS)
def test_input_specs_and_axes_equal_jax(arch):
    """Every leaf's shape is JAX's; its dtype too, but the top-level token,
    label and position ids, int64 in the port where JAX's are int32."""
    import jax

    import repro.configs.registry as JR
    import repro.launch.specs as JS
    from repro.configs.base import SHAPES as JSHAPES

    def jax_paths(tree, is_leaf=None):
        return [("/".join(str(p.key) for p in path), leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]

    for name in SHAPES:
        mine = _paths(TS.input_specs(TR.get_config(arch), SHAPES[name]))
        theirs = jax_paths(JS.input_specs(JR.get_config(arch), JSHAPES[name]))
        assert [p for p, _ in mine] == [p for p, _ in theirs], (arch, name)
        for (path, t), (_, s) in zip(mine, theirs):
            assert t.device.type == "meta" and tuple(t.shape) == tuple(s.shape), (arch, name, path)
            want = "int64" if path in ("tokens", "labels", "positions") else str(s.dtype)
            assert str(t.dtype).replace("torch.", "") == want, (arch, name, path, t.dtype, s.dtype)
        axes = _paths(TS.batch_logical_axes(TR.get_config(arch), SHAPES[name]))
        jaxes = jax_paths(JS.batch_logical_axes(JR.get_config(arch), JSHAPES[name]),
                          is_leaf=lambda x: isinstance(x, tuple))
        assert axes == jaxes, (arch, name)


_JAX_DRYRUN = """
import json
from repro.launch.dryrun import _shard_tree, run_cell  # forces 512 host devices
import jax
from repro.configs.base import SHAPES
from repro.configs.registry import ARCHS, cell_skip_reason, get_config
from repro.launch.mesh import dp_size, make_production_mesh
from repro.launch.specs import batch_logical_axes, input_specs, shape_cfg
from repro.sharding.partitioning import DEFAULT_RULES

def norm(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]

out = {"specs": {}, "skips": {}}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    key = "2x16x16" if mp else "16x16"
    per = {}
    for a in ARCHS:
        for s in SHAPES:
            if cell_skip_reason(a, s):
                out["skips"][f"{a}|{s}|{key}"] = run_cell(a, s, mp)
                continue
            cfg = shape_cfg(get_config(a), SHAPES[s], dp_size(mesh))
            batch = input_specs(cfg, SHAPES[s])
            sh = _shard_tree(batch_logical_axes(cfg, SHAPES[s]), mesh, DEFAULT_RULES, batch)
            leaves = jax.tree_util.tree_flatten_with_path(sh, is_leaf=lambda x: hasattr(x, "spec"))[0]
            per[f"{a}|{s}"] = [["/".join(str(p.key) for p in path), norm(x.spec)] for path, x in leaves]
    out["specs"][key] = per
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_dryrun():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", _JAX_DRYRUN], capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_batch_and_cache_specs_equal_jax(mesh_key, jax_dryrun):
    """``_shard_tree``'s specs for every cell's batch (the decode caches
    included) on the production meshes, from axis names and sizes alone."""
    from repro_torch.launch.mesh import dp_size

    mesh = MeshShape(*MESHES[mesh_key])
    for arch in TR.ARCHS:
        for name, shape in SHAPES.items():
            if TR.cell_skip_reason(arch, name):
                continue
            cfg = TS.shape_cfg(TR.get_config(arch), shape, dp_size(mesh))
            batch = TS.input_specs(cfg, shape)
            sh = TD._shard_tree(TS.batch_logical_axes(cfg, shape), mesh, DEFAULT_RULES, batch)
            mine = [[p, _norm(s.spec)] for p, s in _paths(sh)]
            assert mine == jax_dryrun["specs"][mesh_key][f"{arch}|{name}"], (mesh_key, arch, name)


def test_skip_records_equal_jax(jax_dryrun):
    n = 0
    for key, theirs in jax_dryrun["skips"].items():
        arch, name, mesh = key.split("|")
        assert TD.run_cell(arch, name, mesh == "2x16x16") == theirs, key
        assert theirs["reason"] == TR.cell_skip_reason(arch, name)
        n += 1
    assert n == 2 * sum(1 for a in TR.ARCHS for s in SHAPES if TR.cell_skip_reason(a, s)) > 0


# -------------------------------------------------------------- renderers
_CELLS = [
    {
        "arch": "a", "shape": "train_4k", "mesh": "16x16", "status": "ok", "compile_s": 1.0,
        "memory": {"argument_size_in_bytes": 1, "temp_size_in_bytes": 2, "output_size_in_bytes": 3},
        "useful_flops_ratio": 0.7,
        "roofline": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5, "dominant": "memory",
                     "collective_breakdown": {"all-gather": {"count": 3, "bytes": 9.0}}},
    },
    {"arch": "b", "shape": "long_500k", "mesh": "16x16", "status": "skipped", "reason": "encoder-only"},
    {"arch": "c", "shape": "decode_32k", "mesh": "16x16", "status": "error", "error": "boom"},
    {
        "arch": "d", "shape": "prefill_32k", "mesh": "2x16x16", "status": "ok", "compile_s": 12.4,
        "memory": {"argument_size_in_bytes": 3e9, "temp_size_in_bytes": 4.5e9, "output_size_in_bytes": 1e8},
        "useful_flops_ratio": 0.93,
        "roofline": {"compute_s": 0.2, "memory_s": 0.1, "collective_s": 0.05, "dominant": "compute",
                     "collective_breakdown": {"reduce-scatter": {"count": 7, "bytes": 1.0},
                                              "all-reduce": {"count": 2.0, "bytes": 4.0}}},
    },
]


def _plan(backend, tile):
    return {"version": 1, "backend": backend, "batch_tile": tile, "temporal": False, "mesh_size": 1}


_SWEEP = [
    {"workload": "1080x1920_r12_b4", "candidates": [
        {"plan": _plan("fused", 4), "model_us": 1500.25, "measured_us": 1612.5},
        {"plan": _plan("fused_streamed", 2), "model_us": 1490.0, "measured_us": 1701.0},
        {"plan": _plan("fused", None), "model_us": 1800.0, "measured_us": 1600.0}],
     "model_pick": 1, "measured_best": 2, "regret": 1701.0 / 1600.0},
]


def test_renderers_equal_jax():
    from repro.launch import roofline as JRoof

    assert TRoof.render_dryrun_table(_CELLS) == JRoof.render_dryrun_table(_CELLS)
    for mesh in ("16x16", "2x16x16"):
        assert TRoof.render_roofline_table(_CELLS, mesh) == JRoof.render_roofline_table(_CELLS, mesh)
    assert TRoof.render_plan_sweep_table(_SWEEP) == JRoof.render_plan_sweep_table(_SWEEP)
    t1, t2 = TRoof.render_dryrun_table(_CELLS), TRoof.render_roofline_table(_CELLS)
    assert "SKIP" in t1 and "all-gather×3" in t1 and "ERROR" in t1
    assert "**memory**" in t2 and "50.0%" in t2
    assert "fused_streamed/bt2" in TRoof.render_plan_sweep_table(_SWEEP)


def test_load_cells_and_main_equal_jax(tmp_path, capsys):
    from repro.launch import roofline as JRoof

    for i, cell in enumerate(_CELLS):
        (tmp_path / f"{i}.json").write_text(json.dumps(cell))
    assert TRoof.load_cells(str(tmp_path)) == JRoof.load_cells(str(tmp_path)) == _CELLS
    TRoof.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("## Dry-run") and TRoof.render_roofline_table(_CELLS) in out
    sweep = tmp_path / "sweep.json"
    sweep.write_text(json.dumps(_SWEEP))
    TRoof.main(["--plan-sweep", str(sweep)])
    assert TRoof.render_plan_sweep_table(_SWEEP) in capsys.readouterr().out


# ----------------------------------------------------- counting twins
def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_loop_counts_every_trip():
    N, D, T = 64, 64, 7

    def f(c, xs):
        for t in range(T):
            c = torch.tanh(c @ xs[t])
        return c

    hc = analyze_step(f, _meta(N, D), _meta(T, D, D))
    assert hc.flops == pytest.approx(T * 2 * N * D * D, rel=0.01)


def test_nested_loops_multiply():
    D, T1, T2 = 32, 3, 5

    def f(c):
        for _ in range(T1):
            for _ in range(T2):
                c = c @ c
        return c

    assert analyze_step(f, _meta(D, D)).flops == pytest.approx(T1 * T2 * 2 * D**3, rel=0.01)


def test_batched_einsum_flops():
    B, M, K, N = 4, 32, 48, 16
    hc = analyze_step(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b), _meta(B, M, K), _meta(B, K, N))
    assert hc.flops == pytest.approx(2 * B * M * K * N, rel=0.01)


def test_slice_in_loop_counts_slice_not_operand():
    """A loop that slices one row a step charges about a row's bytes a
    step (a view moves nothing; its sum reads the row), not the array."""
    S, D = 1024, 256

    def f(xs):
        acc = torch.zeros((), device=xs.device)
        for i in range(S):
            acc = acc + torch.sum(xs[i:i + 1])
        return acc

    hc = analyze_step(f, _meta(S, D))
    assert hc.hbm_bytes < S * (S * D * 4) / 20, hc.hbm_bytes
    assert hc.hbm_bytes >= S * D * 4  # every row read once


def test_traffic_rules():
    """Views and ``expand`` move nothing, a gather its output's bytes, an
    indexed write twice its update's, a stride-0 input each distinct
    element once."""
    x, idx, upd = _meta(64, 32), torch.zeros(8, dtype=torch.long, device="meta"), _meta(8, 32)
    assert analyze_step(lambda t: t.t().reshape(32, 64)[3:7], x).hbm_bytes == 0
    assert analyze_step(lambda t: t.expand(5, 64, 32), x).hbm_bytes == 0
    assert analyze_step(lambda t: torch.index_select(t, 0, idx), x).hbm_bytes == 8 * 32 * 4
    assert analyze_step(lambda t: t.index_put_((idx,), upd), x).hbm_bytes == 2 * 8 * 32 * 4
    row = _meta(32)
    assert analyze_step(lambda t, r: t + r, x, row).hbm_bytes == (64 * 32 + 32 + 64 * 32) * 4
    assert analyze_step(lambda t: t.expand(64, 32) + 1.0, row).hbm_bytes == (32 + 64 * 32) * 4


def test_h100_roofline_terms():
    """The only peaks in the port: the H100's bf16 tensor-core rate, its HBM
    rate and NVLink's rate each way."""
    assert (PEAK_FLOPS, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "nvlink_bw": 450e9}
    cost = HloCost(989e9, 6.7e9, 900e6, {"all-gather": {"count": 2, "bytes": 900e6, "groups": {16: 2}}})
    r = roofline_terms(cost)
    assert (r.compute_s, r.memory_s, r.collective_s) == pytest.approx((1e-3, 2e-3, 2e-3))
    assert r.collective_breakdown == {"all-gather": {"count": 2, "bytes": 900e6}}
    assert r.as_dict()["dominant"] == r.dominant in ("memory", "collective") and r.bound_s == pytest.approx(2e-3)


# ------------------------------------------- cases with a process group
@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cases.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_dryrun_cases.py"), str(out)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_collectives_on_the_ring_model(cases):
    """On an 8-rank group, for an 8 KiB fp32 tensor: all-reduce 2x its
    result, all-gather its result, reduce-scatter its result x 8; a c10d
    all-reduce (the optimizer's norm) as the functional one."""
    b = 64 * 32 * 4
    want = {"all-reduce": 2 * b, "all-gather": 8 * b, "reduce-scatter": (b // 8) * 8, "c10d all-reduce": 2 * b}
    for case, nbytes in want.items():
        (kind, got), = cases["ring"][case].items()
        assert kind == case.replace("c10d ", "") and got["count"] == 1 and got["bytes"] == nbytes, (case, got)
        assert got["groups"] == {"8": 1}, (case, got)


def test_dtensor_product_counts_local_flops_only(cases):
    """A (256, 4096) @ (4096, 4096) product, rows over 16 and columns over
    16 ranks: rank 0's (16, 4096) @ (4096, 256), not the global product
    (which DTensor's sharding propagation also runs, on fake tensors)."""
    assert cases["dtensor"]["flops"] == 2 * 16 * 4096 * 256


def test_mini_dryrun_cell(cases):
    """Smoke gemma2-9b, ``grad_accum=2``, a (2, 4) mesh: its record, the
    argument bytes equal to rank 0's local shards counted by hand, some
    temporaries, a useful-FLOPs ratio in (0, 1]; the group is gone after."""
    m = cases["mini"]
    rec = m["gemma2-9b"]
    assert rec["chips"] == 8 and rec["grad_accum"] == 2 and rec["tokens_per_step"] == 8 * 32
    assert set(rec) == {"chips", "grad_accum", "lower_s", "compile_s", "memory", "cost", "roofline", "model_flops",
                        "useful_flops_ratio", "tokens_per_step"}
    assert rec["memory"]["argument_size_in_bytes"] == m["gemma2-9b_argument_bytes_by_hand"]
    assert rec["memory"]["temp_size_in_bytes"] > 0 and rec["memory"]["output_size_in_bytes"] > 0
    assert 0.0 < rec["useful_flops_ratio"] <= 1.0
    r = rec["roofline"]
    assert r["flops_per_chip"] > 0 and r["hbm_bytes_per_chip"] > 0 and r["collective_bytes_per_chip"] > 0
    assert rec["cost"] == {"flops": r["flops_per_chip"], "bytes accessed": r["hbm_bytes_per_chip"]}
    assert set(r["collective_breakdown"]) <= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    assert r["dominant"] in ("compute", "memory", "collective")
    assert m["group_after"] is False


def test_mesh_flops_add_up_to_one_device(cases):
    """hubert-xlarge's smoke config, whose every sharded dim divides 2 and
    4: its train step's FLOPs per rank x 8 on the (2, 4) mesh equal one
    device's (nothing is computed twice, backward included)."""
    m = cases["mini"]
    one = m["hubert-xlarge_world1"]["roofline"]["flops_per_chip"]
    assert m["hubert-xlarge_world1"]["chips"] == 1
    assert m["hubert-xlarge"]["roofline"]["flops_per_chip"] * 8 == pytest.approx(one, rel=0.01)
    # and one device counts at least the model's 6N FLOPs per token
    assert one >= m["hubert-xlarge_world1"]["model_flops"]


def test_prefill_and_decode_cells_and_refusal(cases):
    """A prefill and a decode cell on the (2, 4) mesh (a prefill's useful
    ratio may pass 1: 2N FLOPs a token count the head for every token, the
    prefill runs it on the last one only); the refusal beside a live group."""
    m = cases["mini"]
    for kind in ("prefill", "decode"):
        rec = m[f"yi-6b_{kind}"]
        assert rec["roofline"]["flops_per_chip"] > 0 and rec["memory"]["argument_size_in_bytes"] > 0, kind
        assert rec["useful_flops_ratio"] > 0.0, kind
    assert m["yi-6b_decode"]["useful_flops_ratio"] <= 1.0
    assert m["refused"] and "process group exists" in m["refused"]


def test_production_cell_on_256_ranks(cases):
    """A production cell through ``run_cell``: the JAX package's keys,
    a nonzero roofline, the fake group destroyed when it returns."""
    rec = cases["production"]["record"]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert {"arch", "shape", "mesh", "status", "chips", "grad_accum", "lower_s", "compile_s", "memory", "cost",
            "roofline", "model_flops", "useful_flops_ratio", "tokens_per_step"} == set(rec)
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"}
    assert rec["roofline"]["compute_s"] > 0 and rec["roofline"]["memory_s"] > 0
    assert rec["roofline"]["collective_s"] > 0
    assert cases["production"]["group_after"] is False


# ---------------------------------------------------------------- the CLI
def test_main_writes_a_record_per_tag_and_fails_on_an_erring_cell(tmp_path, monkeypatch, capsys):
    out = tmp_path / "d"
    with pytest.raises(SystemExit) as e:
        TD.main(["--arch", "yi-6b", "--shape", "long_500k", "--both-meshes", "--out", str(out)])
    assert e.value.code == 0
    names = sorted(os.listdir(out))
    assert names == ["yi-6b__long_500k__16x16.json", "yi-6b__long_500k__2x16x16.json"]
    assert json.loads((out / names[0]).read_text())["status"] == "skipped"
    with pytest.raises(SystemExit) as e:  # an existing cell is kept without --force
        TD.main(["--arch", "yi-6b", "--shape", "long_500k", "--out", str(out)])
    assert e.value.code == 0 and "[skip existing]" in capsys.readouterr().out

    def boom(arch, shape, multi_pod, rules=None):
        raise ValueError("a broken cell")

    monkeypatch.setattr(TD, "run_cell", boom)
    with pytest.raises(SystemExit) as e:
        TD.main(["--arch", "yi-6b", "--shape", "decode_32k", "--out", str(out)])
    assert e.value.code == 1
    rec = json.loads((out / "yi-6b__decode_32k__16x16.json").read_text())
    assert rec["status"] == "error" and rec["error"] == "ValueError: a broken cell" and "traceback" in rec


def test_default_out_is_the_ports_own(tmp_path, monkeypatch):
    """Without ``--out`` records go to ``results/torch_dryrun``, apart from
    the JAX package's ``results/dryrun``."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        TD.main(["--arch", "yi-6b", "--shape", "long_500k"])
    assert e.value.code == 0
    assert os.listdir(tmp_path / "results") == ["torch_dryrun"]
    assert os.listdir(tmp_path / "results" / "torch_dryrun") == ["yi-6b__long_500k__16x16.json"]
