"""Finds what a cell is made of by name: the cell in ``BENCHMARK.json``, its
configuration's file, its traffic mix (``traffic/<name>.json``), the
mix's entry point (``entries/<entry>.py``), its configuration's reference
(``references/<name>.py``) and each metric's reader (``metrics/<name>.py``). A later cell, mix or metric is a new file
and a new entry; nothing here changes for it."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, List

__all__ = ["BENCH_DIR", "Spec", "load_module"]

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """One cell of ``benchmark`` (the parsed ``BENCHMARK.json``), resolved
    against ``root`` (the checkout) and ``bench_dir`` (this folder)."""

    def __init__(self, benchmark: dict, cell: str, root: Path, bench_dir: Path = BENCH_DIR):
        self.benchmark = benchmark
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        cells = {w["name"]: w for w in benchmark["workloads"]}
        if cell not in cells:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json; there are {sorted(cells)}")
        self.cell = cells[cell]
        configs = {c["name"]: c for c in benchmark["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = json.loads((self.root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (self.bench_dir / "traffic" / f"{self.cell['traffic']}.json").read_text())

    @classmethod
    def from_file(cls, path: Path, cell: str) -> "Spec":
        path = Path(path)
        return cls(json.loads(path.read_text()), cell, path.parent)

    def reference(self) -> ModuleType:
        name = self.config["reference"]
        return load_module(self.bench_dir / "references" / f"{name}.py", f"bgbench_reference_{name}")

    def entry(self) -> ModuleType:
        """The loop and the comparison of the mix's entry point."""
        name = self.traffic["entry"]
        path = self.bench_dir / "entries" / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no entry point {name!r} for traffic {self.cell['traffic']!r}")
        return load_module(path, f"bgbench_entry_{name}")

    def metrics(self, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics (``traced`` False) or per-layer
        metrics (True), in ``BENCHMARK.json``'s order."""
        group = self.benchmark["per_layer" if traced else "end_to_end"]
        return [m for m in group if self.cell["name"] in m.get("workloads", [self.cell["name"]])]

    def reader(self, metric: str) -> Callable:
        path = self.bench_dir / "metrics" / f"{metric}.py"
        return load_module(path, "bgbench_metric_" + metric.replace(".", "_").replace("-", "_")).read
