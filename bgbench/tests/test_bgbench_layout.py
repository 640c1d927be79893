"""The benchmark is driven by data: a cell, a configuration, a traffic mix
and a metric are found by name, and a later one is added as new files and
new entries, with no existing file edited. The command's exits."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.spec import Spec  # noqa: E402

BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_resolves_by_name(cell):
    spec = Spec.from_file(REPO / "BENCHMARK.json", cell)
    assert spec.config["name"] == spec.cell["config"]
    entry = spec.entry()
    assert callable(entry.drive) and callable(entry.check)
    assert hasattr(spec.reference(), "filter_frames")
    for traced in (False, True):
        metrics = spec.metrics(traced)
        assert metrics
        for m in metrics:
            assert callable(spec.reader(m["name"]))
    assert {m["name"] for m in spec.metrics(False)} >= {"setup_s", "frames_per_s"}


def test_each_file_belongs_to_one_name():
    names = {m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]}
    assert names == {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    used = {w["traffic"] for w in BENCHMARK["workloads"]}
    assert used == {p.stem for p in (BENCH / "traffic").glob("*.json")}
    entries = {json.loads((BENCH / "traffic" / f"{t}.json").read_text())["entry"] for t in used}
    assert entries == {p.stem for p in (BENCH / "entries").glob("*.py")}
    assert {c["file"] for c in BENCHMARK["configs"]} == {
        str(p.relative_to(REPO)) for p in (BENCH / "configs").glob("*.json")}
    for c in BENCHMARK["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("mix", sorted(p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_every_stream_of_an_open_loop_gets_a_frame_of_its_own_each_tick(mix):
    traffic = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    if traffic["entry"] != "packer":
        pytest.skip("a closed loop has no streams")
    from harness.spec import load_module

    packer = load_module(BENCH / "entries" / "packer.py", "bgbench_entry_packer_test")
    n, n_pool = int(traffic["streams"]), int(traffic["pool_frames"])
    for tick in (0, 1, 57, 3 * n_pool + 5):
        frames = [packer.frame_index(tick, s, traffic, n_pool) for s in range(n)]
        assert len(set(frames)) == n, (mix, tick)
    assert 1 <= int(traffic["check_streams"]) <= n


_SINGLE = '''"""A later entry point: one frame a dispatch, waited for."""
import time

import torch

from harness.check import Verdict
from harness.drive import bg_config, sync


def drive(run, pool, seed, seconds, device, precision, tracer, t_start):
    from repro_torch.plan import plan_for
    from repro_torch.serving.frames import FrameDenoiseEngine, FrameRequest

    cfg = run.config
    plan = plan_for(bg_config(cfg), int(cfg["height"]), int(cfg["width"]), n_frames=1,
                    cache=False, device=device, precision=precision)
    run.plan = plan.describe()
    eng = FrameDenoiseEngine(plan=plan, max_batch=1)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    kept, k = [], 0
    while time.perf_counter() - t0 < seconds or len(kept) < 2:
        a = time.perf_counter()
        eng.submit(FrameRequest(k, pool[k % pool.shape[0]]))
        (req,) = eng.step()
        sync(device)
        run.span("single", a, time.perf_counter())
        kept.append((k % pool.shape[0], req.result))
        k += 1
    run.window_s = time.perf_counter() - t0
    run.attempted = run.completed = k
    return kept[:2]


def check(run, ref, pool, kept):
    verdict = Verdict(run.config["limits"])
    for j, out in kept:
        verdict.add(out, ref.filter_frames(pool[j:j + 1], ref.BG(run.config)))
    return verdict
'''


def _digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_later_cell_config_mix_and_metric_are_new_files_only(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bgbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "bgbench")
    new = tmp_path / "bgbench"
    cfg = json.loads((new / "configs" / "bg-fullhd-r12.json").read_text())
    cfg.update(name="bg-later-r6", r=6, height=48, width=64)
    (new / "configs" / "bg-later-r6.json").write_text(json.dumps(cfg))
    mix = json.loads((new / "traffic" / "batch16.json").read_text())
    mix.update(frames_per_dispatch=4, pool_frames=8)
    (new / "traffic" / "batch4.json").write_text(json.dumps(mix))
    (new / "entries" / "single_frame.py").write_text(_SINGLE)
    (new / "traffic" / "single.json").write_text(json.dumps(dict(mix, entry="single_frame")))
    (new / "metrics" / "dispatch_rate.batch.py").write_text(
        "def read(run):\n    spans = run.spans.get('engine')\n"
        "    return len(spans) / run.window_s if spans else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bg-later-r6", "source": cfg["source"],
                             "file": "bgbench/configs/bg-later-r6.json", "reduced": [],
                             "why": "a later window radius"})
    bench["workloads"].append({"name": "later-r6.batch4", "config": "bg-later-r6",
                               "traffic": "batch4", "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "dispatch_rate.batch", "unit": "1/s", "better": "higher",
                               "source": "program_span", "layer": "frame engine (serving/frames.py)",
                               "moves": "frames_per_s", "workloads": ["later-r6.batch4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench["workloads"].append({"name": "later-r6.single", "config": "bg-later-r6",
                               "traffic": "single", "chips": 1, "why": "a later entry point"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(bench, "later-r6.batch4", tmp_path, new)
    assert spec.config["r"] == 6 and spec.traffic["frames_per_dispatch"] == 4

    from harness.result import run_cell

    result, _ = run_cell(spec, 77, 0.3, True, "cpu", time.perf_counter())
    assert result["correct"]
    assert result["metrics"]["dispatch_rate.batch"]["value"] > 0
    result, _ = run_cell(Spec(bench, "later-r6.single", tmp_path, new), 78, 0.2, False, "cpu",
                         time.perf_counter())
    assert result["correct"] and result["checks"]["frames_checked"] == 2
    assert result["metrics"]["frames_per_s"]["value"] > 0
    after = _digest(new)
    assert {k: v for k, v in after.items() if k in before} == before


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "bgbench/run.py", *args], capture_output=True,
                          text=True, cwd=str(cwd), env=env, timeout=timeout)


def test_the_command_refuses_an_unknown_cell_and_a_host_without_the_card():
    proc = _run(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"], REPO)
    assert proc.returncode == 2 and proc.stdout == ""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for a host without one")
    proc = _run(["--workload", BENCHMARK["workloads"][0]["name"], "--seed", str(2 ** 31 + 9),
                 "--seconds", "1", "--trace", "0"], REPO)
    assert proc.returncode == 3 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_the_command_fails_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bgbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(["--workload", BENCHMARK["workloads"][0]["name"], "--seed", "5",
                 "--seconds", "1"], tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
