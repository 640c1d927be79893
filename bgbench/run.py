"""Run one cell of the benchmark once and print its result as the last line.

    python3 bgbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The program under test is ``repro_torch``
(under ``src/``); the JAX package beside it is never imported. The cell's
configuration, traffic mix and metric readers are found by name
(``harness/spec.py``). Exit codes: 0 with a result line; 2 for bad
arguments; 3 without a CUDA card (or with fewer than the cell asks for);
4 when a JAX module was loaded; 5 without the program (`src/repro_torch`); any
other when the run failed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The program builds its CUDA sources into ``build/torch_kernels``."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["REPRO_TORCH_PLAN_CACHE"] = str(build / "bgbench" / "plan_cache.json")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    args = _args(argv)
    _caches()
    sys.path.insert(0, str(ROOT / "src"))
    from harness.spec import Spec

    try:
        spec = Spec.from_file(ROOT / "BENCHMARK.json", args.workload)
    except (FileNotFoundError, KeyError) as exc:
        print(f"bgbench: {exc}", file=sys.stderr)
        return 2

    import torch

    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bgbench: the cell needs {chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3

    try:
        import repro_torch  # noqa: F401  the program under test
    except ImportError as exc:
        print(f"bgbench: the program under test is missing: {exc}", file=sys.stderr)
        return 5
    from harness.result import run_cell

    result, notes = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"bgbench: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 4
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
