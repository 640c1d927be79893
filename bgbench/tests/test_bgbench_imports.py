"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the program's name begins with the JAX
package's), and the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HARNESS = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_harness_source_imports_jax_or_the_jax_package():
    assert len(HARNESS) >= 15
    bad = {str(p.relative_to(BENCH)): m for p in HARNESS for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN}
    assert not bad, bad
    # the program is imported, under its own whole name
    assert any(m.split(".")[0] == "repro_torch" for p in HARNESS for m in _imports(p))


def test_the_reference_imports_only_torch_and_numpy():
    for path in (BENCH / "references").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "numpy", "torch"}, (path.name, tops)


def test_a_run_loads_no_jax_module():
    """A whole run of a cell at a tiny size on the CPU, in a fresh
    interpreter: no module whose top-level name is forbidden is loaded."""
    code = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(REPO / 'src')!r}]
from harness.spec import Spec
from harness.result import run_cell
import run
for cell in ("fullhd-r12.batch16", "fullhd-r12.live60"):
    spec = Spec.from_file({str(REPO / 'BENCHMARK.json')!r}, cell)
    spec.config.update(height=40, width=56)
    spec.traffic.update(pool_frames=4, streams=min(spec.traffic.get("streams", 3), 3))
    result, _ = run_cell(spec, 2 ** 31 + 1, 0.3, cell.endswith("live60"), "cpu", time.perf_counter())
    assert result["correct"], result
print("loaded:", run.forbidden_modules())
"""
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "loaded: []"
