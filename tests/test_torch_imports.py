"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no JAX
and nothing of the JAX package ``repro``, checked both by importing every
module in a fresh interpreter and by scanning the sources."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch, repro_torch.serving, repro_torch.launch.serve
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("repro_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[1]) >= 15


NEW_IN_SLICE_3 = ["kernels._wrap", "kernels.bg_create", "kernels.bg_blur", "kernels.bg_slice"]
# the modules the bf16 storage form runs through (the storage helpers, the
# fused wrapper, the plan, the video carries and the staged oracle's grid)
BF16_PATH = ["kernels.common", "kernels.bg_fused", "plan", "video.session", "video.temporal"]
# plan selection and guarded dispatch: the cache, the reliability layer, and
# the engine and launcher that use them
PLAN_AND_RELIABILITY = ["plan_cache", "reliability.errors", "reliability.retry", "reliability.faults",
                        "serving.async_engine", "launch.serve"]


@pytest.mark.parametrize("name", NEW_IN_SLICE_3 + BF16_PATH + PLAN_AND_RELIABILITY)
def test_kernel_modules_import_alone_without_jax(name):
    """Each kernel module imports in a fresh interpreter by itself, loading
    no JAX, nothing of ``repro`` and no compiled kernel (the CPU host has no
    nvcc: a kernel is built at its first launch, never at import)."""
    code = f"""
import importlib, sys
importlib.import_module("repro_torch.{name}")
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
from repro_torch.kernels import _build
assert not _build._libs, sorted(_build._libs)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"
