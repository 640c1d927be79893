"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``<repo>/build/torch_kernels/<name>-<hash>.so``, where the hash
covers the source, every ``csrc/*.cuh`` header it includes (directly or
through another header) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded from the cache. ``-Xptxas -v`` is always on; its
report (registers, shared memory, spills) is kept beside the library in
``<name>-<hash>.log`` and returned by :func:`build_log`.

Nothing here runs at import time: the CPU-only test host has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

from repro_torch import tracing
from repro_torch.reliability.errors import KernelBuildError, KernelLaunchError

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build_all", "build_log", "check", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
# every kernel source of the port (``csrc/<name>.cu``)
SOURCES = tuple(sorted(p.stem for p in _CSRC.glob("*.cu")))
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_compiles = 0  # sources compiled by build_all in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built on the machine with the card"
    )


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """``<name>.cu`` and the ``csrc`` files it includes, transitively, in a
    fixed order."""
    seen, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        todo.extend(m.decode() for m in _INCLUDE.findall((_CSRC / f).read_bytes()))
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for f in _sources(name):
        h.update(f.encode() + b"\0" + (_CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not cached yet, one nvcc process
    each, all started together; returns ``{name: library path}``. Raises
    ``KernelBuildError`` (a ``RuntimeError``) with nvcc's output if any
    build fails."""
    names = list(names)
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        global _compiles
        _compiles += len(todo)
        tracing.count("build", len(todo))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            todo[n].with_suffix(".log").write_text(log)
            os.replace(tmp, todo[n])  # atomic: concurrent builds agree
        if failed:
            raise KernelBuildError("\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """nvcc's output (the ``-Xptxas -v`` report) for ``name``'s current build."""
    return _target(name).with_suffix(".log").read_text()


def load(name: str, signatures: Optional[Dict[str, tuple]] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed, with
    every entry point of ``signatures`` (``{symbol: (argtypes, restype)}``)
    bound. Every source exports ``<name>_error_string(int)``, bound here.
    Raises ``KernelBuildError`` when the library does not load or lacks an
    entry point."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            compiles = _compiles
            path = build_all([name])[name]
            if _compiles == compiles:  # build_all compiled, and counted, nothing
                tracing.count("build")  # a library built before, loaded from disk
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise KernelBuildError(f"{name}: cannot load {path.name}: {exc}") from exc
            _bind(lib, name, {f"{name}_error_string": ([ctypes.c_int], ctypes.c_char_p)})
            _libs[name] = lib
        _bind(lib, name, signatures or {})
        return lib


def _bind(lib: ctypes.CDLL, name: str, signatures: Dict[str, tuple]) -> None:
    for symbol, (argtypes, restype) in signatures.items():
        try:
            fn = getattr(lib, symbol)
        except AttributeError as exc:
            raise KernelBuildError(f"{name}: the library has no entry point {symbol}") from exc
        fn.argtypes, fn.restype = argtypes, restype


def check(name: str, err: int) -> None:
    """Raise ``KernelLaunchError`` (a ``RuntimeError``) unless ``err`` (the
    ``cudaGetLastError()`` a launch function of ``csrc/<name>.cu``
    returned) is 0."""
    if err != 0:
        msg = getattr(_libs[name], f"{name}_error_string")(err).decode()
        raise KernelLaunchError(f"{name} launch failed: CUDA error {err} ({msg})")
