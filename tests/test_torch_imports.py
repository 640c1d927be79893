"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no JAX,
no ``ml_dtypes`` and nothing of the JAX package ``repro``, checked by
importing every module in a fresh interpreter, by scanning the sources, and
by running a fleet worker's child process."""
import ast
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch, repro_torch.serving, repro_torch.launch.serve
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
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
# the fleet: every module of repro_torch.fleet, and the launcher that fronts it
FLEET = ["fleet", "fleet.errors", "fleet.codec", "fleet.stats", "fleet.health", "fleet.worker",
         "fleet.controller", "fleet.router", "fleet.remote", "fleet.remote_worker"]
# the rest of the image core, the data frontends and the examples
CORE_AND_EXAMPLES = ["core.bilateral_filter", "core.fixed_point", "core.streaming", "core",
                     "data.pipeline", "data.synthetic", "data", "examples", "examples.quickstart",
                     "examples.denoise_stream", "examples.denoise_video", "examples.denoise_fleet"]
# batch sharding: the mesh module and the package that exports it
SHARDING = ["sharding", "sharding.bg_shard"]
# the LM serving substrate: the registry (every arch config), the model
# stack (every models module), the engine and samplers, the LM examples
LM_SERVING = ["configs.registry", "models.model", "models.frontends", "serving.engine",
              "examples.serve_lm", "examples.vlm_preprocess"]
# LM training and checkpoints: every train and checkpoint module, the
# train launcher and the train example
LM_TRAINING = ["train", "train.optimizer", "train.train_step", "train.trainer", "train.grad_compress",
               "checkpoint", "checkpoint.checkpointer", "checkpoint.manager", "launch.train",
               "examples.train_lm"]
# LM sharding: the DTensor shims and rules, ring attention, GPipe, the
# elastic restore, the production mesh and the shared sharding helper
LM_SHARDING = ["sharding.compat", "sharding.partitioning", "sharding.ring_attention",
               "sharding.pipeline_parallel", "checkpoint.elastic", "launch.mesh", "launch.dryrun"]
# the dry-run and roofline tooling (no process group and no JAX at import)
DRYRUN = ["launch.specs", "launch.hlo_cost", "launch.hlo_analysis", "launch.roofline"]


@pytest.mark.parametrize("name", NEW_IN_SLICE_3 + BF16_PATH + PLAN_AND_RELIABILITY + FLEET
                         + CORE_AND_EXAMPLES + SHARDING + LM_SERVING + LM_TRAINING + LM_SHARDING + DRYRUN)
def test_kernel_modules_import_alone_without_jax(name):
    """Each kernel module imports in a fresh interpreter by itself, loading
    no JAX, no ``ml_dtypes``, nothing of ``repro`` and no compiled kernel (the CPU host has no
    nvcc: a kernel is built at its first launch, never at import)."""
    code = f"""
import importlib, sys
importlib.import_module("repro_torch.{name}")
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
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


def test_fleet_child_process_loads_no_jax(tmp_path):
    """A ``python -m repro_torch.fleet.remote_worker`` child, taken through
    HELLO, PLAN (on the CPU), READY and SHUTDOWN by a parent played here
    with the port's codec, has loaded no JAX, no ``ml_dtypes`` and nothing
    of ``repro`` when it exits; the modules are read at its exit."""
    sys.path.insert(0, str(REPO / "src"))
    try:
        from repro_torch.core import BGConfig
        from repro_torch.fleet import PlanController, codec
        from repro_torch.plan import BGPlan
    finally:
        sys.path.remove(str(REPO / "src"))
    plan = BGPlan(BGConfig(r=4, sigma_s=4.0, sigma_r=60.0), backend="fused", temporal=True,
                  device="cpu")
    report = tmp_path / "modules.json"
    wrapper = f"""
import atexit, json, runpy, sys
atexit.register(lambda: open({str(report)!r}, "w").write(json.dumps(sorted(sys.modules))))
sys.argv[0] = "remote_worker"
runpy.run_module("repro_torch.fleet.remote_worker", run_name="__main__")
"""
    sock_dir = tempfile.mkdtemp(prefix="bgfleet-imports-")
    path = os.path.join(sock_dir, "w.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(path)
    listener.listen(1)
    listener.settimeout(60.0)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", wrapper, "--wid", json.dumps(0), "--connect", f"unix:{path}"],
        env=env, stdin=subprocess.DEVNULL,
    )
    try:
        conn, _ = listener.accept()
        conn.settimeout(60.0)
        name, hdr, _ = codec.read_message(conn.recv)
        assert name == "hello" and hdr["wid"] == 0
        conn.sendall(codec.encode("plan", {
            "payload": PlanController(plan).payload(), "device": "cpu",
            "worker_kwargs": {}, "heartbeat_interval_s": 60.0, "snapshot_interval_s": 60.0,
        }))
        name, hdr, _ = codec.read_message(conn.recv)
        assert name == "ready" and hdr["plan_hash"] == plan.plan_hash(), (name, hdr)
        conn.sendall(codec.encode("shutdown", {"timeout": 5.0}))
        assert proc.wait(timeout=60) == 0
        conn.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        listener.close()
        os.unlink(path)
        os.rmdir(sock_dir)
    loaded = json.loads(report.read_text())
    assert "repro_torch.fleet.worker" in loaded and "torch" in loaded
    bad = sorted(n for n in loaded if _forbidden(n))
    assert not bad, bad
