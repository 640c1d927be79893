"""Persistent measured-plan cache, the stored artifact behind ``plan_for``:
the port of ``repro/plan_cache.py``.

The cost model in :mod:`repro_torch.plan` predicts the fastest legal plan
for a workload; ``chip_smoke.py``'s ``plan_sweep`` phase measures it on the
card. This module keeps the measured winners between processes: a small
JSON file mapping

    workload key  ->  {plan: BGPlan.to_json(), plan_hash, measured_us, ...}

that ``plan_for`` consults before the model. The key holds everything that
makes a measurement transferable:

  * the workload: ``(h, w)``, every ``BGConfig`` field, the pack size
    ``n_frames``, ``temporal`` and the mesh size;
  * the host fingerprint (:func:`host_fingerprint`): machine, torch version
    and the plan's device (the CUDA card's name and compute capability, or
    ``cpu``). A JAX host's fingerprint names its JAX backend, so an entry
    either package records never matches a lookup of the other.

The file format is the JAX package's (version 2, the same entry and
calibration layout), so ``merge`` unions files written by either package;
each package's entries stay inert in the other. The default file is the
port's own (``~/.cache/repro_torch/bg_plan_cache.json``, or
``$REPRO_TORCH_PLAN_CACHE``), so that ``prune --foreign`` here cannot evict
the JAX package's entries, and the reverse.

A missing, truncated or garbage file reads as empty (one warning): a broken
cache degrades to the model, never takes the service down. Writes are
atomic (a temporary file, then a rename).

The module is also the operator's cache tool::

    python -m repro_torch.plan_cache inspect [path] [--json]
    python -m repro_torch.plan_cache merge OUT IN [IN ...]
    python -m repro_torch.plan_cache prune [path] --max-age-days N | --foreign \\
        | --stale-schema

``inspect`` prints every entry (key, backend, tile, mesh, precision,
measured time, hash, age) and the calibrations; ``merge`` unions files,
same-key conflicts going to the fastest measurement (ties to the newer
recording); ``prune`` drops entries older than ``--max-age-days``, entries
recorded under a fingerprint of another host (``--foreign``: neither of this
host's, the card's nor the CPU's), and entries of an older schema
(``--stale-schema``). The ``calibration`` section (the cost model's overhead
constants fitted per fingerprint by ``plan_sweep``) rides the same file.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence

__all__ = [
    "PlanCache",
    "workload_key",
    "host_fingerprint",
    "default_cache_path",
    "get_default_cache",
    "set_default_cache",
    "merge_caches",
    "main",
    "CACHE_ENV_VAR",
    "CACHE_VERSION",
]

CACHE_ENV_VAR = "REPRO_TORCH_PLAN_CACHE"
# v2: BGPlan serialization gained `precision` (it participates in the plan
# hash, so v1 measurements vouch for plans whose hash no longer reproduces).
# Bumping the version retires every v1 key by construction (workload keys
# embed `v{CACHE_VERSION}|`), and `prune --stale-schema` evicts the bodies.
CACHE_VERSION = 2


def host_fingerprint(device=None) -> str:
    """Machine, torch version and device, baked into every workload key.

    ``device`` is a plan's device; ``None`` names the CUDA card when there
    is one, else the CPU. A card is named with its compute capability
    (``cuda-NVIDIA_H100_80GB_HBM3-sm90``), the CPU with its core count.
    Entries recorded under another fingerprint never match a lookup here.
    """
    import platform

    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        major, minor = torch.cuda.get_device_capability(index)
        name = torch.cuda.get_device_name(index).replace(" ", "_").replace("|", "_")
        desc = f"cuda-{name}-sm{major}{minor}"
    else:
        desc = f"{os.cpu_count()}cpu-cpu"
    return f"{platform.machine()}-torch{torch.__version__}-{desc}"


def _local_fingerprints() -> set:
    """This host's fingerprints: the CPU's, and the card's when there is one."""
    import torch

    fps = {host_fingerprint("cpu")}
    if torch.cuda.is_available():
        fps.add(host_fingerprint("cuda"))
    return fps


def workload_key(
    cfg,
    h: int,
    w: int,
    n_frames: Optional[int] = None,
    temporal: bool = False,
    mesh_size: int = 1,
    *,
    device=None,
) -> str:
    """Canonical cache key for one (workload, host) pair; ``device`` is the
    plan's (:func:`host_fingerprint`)."""
    return (
        f"v{CACHE_VERSION}|{host_fingerprint(device)}|h{int(h)}w{int(w)}"
        f"|r{cfg.r}ss{cfg.sigma_s:g}sr{cfg.sigma_r:g}im{cfg.intensity_max:g}"
        f"|{cfg.normalize_mode}.{cfg.weight_mode}"
        f"|n{'any' if n_frames is None else int(n_frames)}"
        f"|t{int(bool(temporal))}|m{int(mesh_size)}"
    )


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV_VAR)
    if env:
        return os.path.expanduser(env)
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "bg_plan_cache.json"
    )


class PlanCache:
    """On-disk JSON store of measured-best plans, keyed by workload + host.

    Lazy-loading and tolerant: a missing or corrupt file reads as empty (one
    warning per instance), and every ``record`` rewrites the file atomically.
    Thread-safe for the engine-construction paths that race ``plan_for``.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.expanduser(path) if path else default_cache_path()
        self._entries: Optional[dict] = None
        self._calib: dict = {}
        self._lock = threading.Lock()
        self._warned = False

    # ------------------------------------------------------------------ io
    def _load(self) -> dict:
        if self._entries is not None:
            return self._entries
        entries: dict = {}
        calib: dict = {}
        try:
            with open(self.path) as f:
                data = json.load(f)
            # Every known schema version (1..CACHE_VERSION) loads: keys
            # embed their own `v{N}|` prefix, so entries written under an
            # older schema are inert (never match a lookup) rather than
            # dangerous, and `prune --stale-schema` can evict them. Future
            # versions and foreign layouts are refused (treated as empty).
            if (
                isinstance(data, dict)
                and isinstance(data.get("version"), int)
                and 1 <= data["version"] <= CACHE_VERSION
                and isinstance(data.get("entries"), dict)
            ):
                entries = data["entries"]
                if isinstance(data.get("calibration"), dict):
                    calib = data["calibration"]
            elif not self._warned:
                self._warned = True
                warnings.warn(
                    f"plan cache {self.path}: unrecognized layout "
                    f"(version not in 1..{CACHE_VERSION}); treating as empty"
                )
        except FileNotFoundError:
            pass
        except (OSError, json.JSONDecodeError, TypeError, ValueError) as e:
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"plan cache {self.path} is unreadable ({e!r}); treating "
                    f"as empty; the model serves serves until a sweep "
                    f"rewrites it"
                )
        self._entries = entries
        self._calib = calib
        return entries

    def _write(self) -> None:
        payload = {"version": CACHE_VERSION, "entries": self._entries or {}}
        if self._calib:
            payload["calibration"] = self._calib
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".plan_cache.", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)  # atomic on POSIX
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ----------------------------------------------------------------- api
    def lookup(self, key: str) -> Optional[dict]:
        """The entry for ``key``, or None. Entries are plain dicts with at
        least ``plan`` (a ``BGPlan.to_json`` payload) and ``plan_hash``."""
        with self._lock:
            ent = self._load().get(key)
            if not isinstance(ent, dict) or "plan" not in ent:
                return None
            return ent

    def record(
        self,
        key: str,
        plan,
        measured_us: Optional[float] = None,
        model_us: Optional[float] = None,
        source: str = "sweep",
    ) -> dict:
        """Store ``plan`` as the measured winner for ``key`` (atomic write)."""
        entry = {
            "plan": plan.to_json(),
            "plan_hash": plan.plan_hash(),
            "measured_us": measured_us,
            "model_us": model_us,
            "source": source,
            "recorded": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        with self._lock:
            self._load()
            self._entries[key] = entry
            self._write()
        return entry

    def record_calibration(self, fingerprint: str, constants: dict) -> dict:
        """Store fitted cost-model overhead constants for one fingerprint.

        ``constants`` is a plain JSON dict (``chip_smoke.py``'s
        ``plan_sweep`` writes the least-squares fit of the dispatch, frame,
        launch and streamed-launch overheads and the fit's residual).
        Calibration is provenance: ``plan_cost`` keeps the constants written
        in ``repro_torch/plan.py``, so recording a fit never changes which
        plan a fresh process selects.
        """
        entry = {
            "constants": dict(constants),
            "recorded": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        with self._lock:
            self._load()
            self._calib[fingerprint] = entry
            self._write()
        return entry

    def calibration(self, fingerprint: str) -> Optional[dict]:
        """The recorded calibration entry for ``fingerprint``, or None."""
        with self._lock:
            self._load()
            ent = self._calib.get(fingerprint)
            return dict(ent) if isinstance(ent, dict) else None

    def calibrations(self) -> Dict[str, dict]:
        """Snapshot copy of every host's calibration entry."""
        with self._lock:
            self._load()
            return dict(self._calib)

    def clear(self) -> None:
        with self._lock:
            self._entries = {}
            self._calib = {}
            self._write()

    def entries(self) -> Dict[str, dict]:
        """A snapshot copy of every entry (CLI/merge consumption)."""
        with self._lock:
            return dict(self._load())

    def prune(
        self,
        max_age_days: Optional[float] = None,
        foreign: bool = False,
        stale_schema: bool = False,
        now: Optional[float] = None,
    ) -> List[str]:
        """Drop stale, foreign-host, and/or old-schema entries; returns
        removed keys.

        ``max_age_days`` removes entries whose ``recorded`` stamp is older
        (or unparseable: an entry of unknown age fails the age criterion);
        ``foreign`` removes entries keyed under a fingerprint that is not
        one of this host's (:func:`host_fingerprint` of the card or the
        CPU: they can never match a lookup here);
        ``stale_schema`` removes entries keyed under an older
        ``CACHE_VERSION`` prefix (equally unreachable since the version is
        baked into every :func:`workload_key`). At least one criterion is
        required.
        """
        if max_age_days is None and not foreign and not stale_schema:
            raise ValueError(
                "prune needs max_age_days=, foreign=True, and/or "
                "stale_schema=True"
            )
        fps = _local_fingerprints() if foreign else None
        prefix = f"v{CACHE_VERSION}|"
        now = time.time() if now is None else now
        removed = []
        with self._lock:
            for key, ent in list(self._load().items()):
                drop = False
                if stale_schema:
                    drop = not key.startswith(prefix)
                if not drop and foreign:
                    parts = key.split("|")
                    drop = len(parts) < 2 or parts[1] not in fps
                if not drop and max_age_days is not None:
                    drop = _entry_age_days(ent, now) > max_age_days
                if drop:
                    del self._entries[key]
                    removed.append(key)
            if removed:
                self._write()
        return removed

    def __len__(self) -> int:
        with self._lock:
            return len(self._load())


# One process-wide default instance (what plan_for consults when no explicit
# cache is passed). Replaceable for tests / controller processes.
_DEFAULT_CACHE: Optional[PlanCache] = None
_DEFAULT_LOCK = threading.Lock()


def get_default_cache() -> PlanCache:
    global _DEFAULT_CACHE
    with _DEFAULT_LOCK:
        if _DEFAULT_CACHE is None or _DEFAULT_CACHE.path != default_cache_path():
            # re-resolve when REPRO_PLAN_CACHE changed (tests point it at
            # tmp dirs; long-lived processes keep one instance otherwise)
            _DEFAULT_CACHE = PlanCache()
        return _DEFAULT_CACHE


def set_default_cache(cache: Optional[PlanCache]) -> Optional[PlanCache]:
    """Install ``cache`` as the process default; returns the previous one."""
    global _DEFAULT_CACHE
    with _DEFAULT_LOCK:
        prev = _DEFAULT_CACHE
        _DEFAULT_CACHE = cache
        return prev


# ------------------------------------------------------------------- tooling
def _entry_age_days(ent: dict, now: float) -> float:
    """Days since ``ent`` was recorded; +inf for missing/garbled stamps
    (an entry of unknown age cannot pass an age criterion)."""
    stamp = ent.get("recorded") if isinstance(ent, dict) else None
    try:
        recorded = time.mktime(time.strptime(stamp, "%Y-%m-%dT%H:%M:%S"))
    except (TypeError, ValueError):
        return float("inf")
    return (now - recorded) / 86400.0


def _better(a: dict, b: dict) -> dict:
    """Conflict resolution for merge: fastest measurement wins (an
    unmeasured entry loses to any measured one); ties go to the newer
    recording (the ISO stamps sort lexicographically)."""
    inf = float("inf")

    def measured(e):
        v = e.get("measured_us")
        return v if isinstance(v, (int, float)) else inf

    if measured(a) != measured(b):
        return a if measured(a) < measured(b) else b
    return a if str(a.get("recorded", "")) >= str(b.get("recorded", "")) else b


def merge_caches(out_path: str, in_paths: Sequence[str]) -> PlanCache:
    """Union the entries of ``in_paths`` into a cache file at ``out_path``
    (which also participates when it already exists: merging into the
    fleet's shipped cache is the normal flow). Calibration sections union
    per-fingerprint with the newer recording winning. Returns the written
    cache."""
    merged: Dict[str, dict] = {}
    calib: Dict[str, dict] = {}
    for path in [out_path, *in_paths]:
        if path != out_path and not os.path.exists(os.path.expanduser(path)):
            raise FileNotFoundError(path)
        src = PlanCache(path)
        for key, ent in src.entries().items():
            if not isinstance(ent, dict) or "plan" not in ent:
                continue
            merged[key] = _better(merged[key], ent) if key in merged else ent
        for fp, ent in src.calibrations().items():
            if not isinstance(ent, dict):
                continue
            prev = calib.get(fp)
            if prev is None or str(ent.get("recorded", "")) >= str(
                prev.get("recorded", "")
            ):
                calib[fp] = ent
    out = PlanCache(out_path)
    with out._lock:
        out._entries = merged
        out._calib = calib
        out._write()
    return out


def _format_entry(key: str, ent: dict, now: float) -> str:
    plan = ent.get("plan") if isinstance(ent, dict) else None
    plan = plan if isinstance(plan, dict) else {}
    measured = ent.get("measured_us")
    age = _entry_age_days(ent, now)
    return (
        f"{key}\n"
        f"    backend={plan.get('backend')} bt={plan.get('batch_tile')} "
        f"mesh={plan.get('mesh_size')} temporal={int(bool(plan.get('temporal')))}"
        f" prec={plan.get('precision', 'fp32')}"
        f" hash={ent.get('plan_hash')}\n"
        f"    measured_us="
        f"{'-' if not isinstance(measured, (int, float)) else f'{measured:.1f}'}"
        f" source={ent.get('source')} recorded={ent.get('recorded')}"
        f" ({'?' if age == float('inf') else f'{age:.1f}'}d ago)"
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m repro_torch.plan_cache``: see the module docstring."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan_cache",
        description="Inspect, merge, and prune measured-plan cache files.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    ins = sub.add_parser("inspect", help="print every entry of a cache file")
    ins.add_argument("path", nargs="?", default=None,
                     help="cache file (default: the process default path)")
    ins.add_argument("--json", action="store_true", dest="as_json",
                     help="dump raw entries as JSON")
    mer = sub.add_parser(
        "merge",
        help="union cache files into OUT (fastest measurement wins per key)",
    )
    mer.add_argument("out", help="destination cache file")
    mer.add_argument("inputs", nargs="+", help="source cache files")
    pru = sub.add_parser(
        "prune", help="drop stale, foreign, and/or old-schema entries"
    )
    pru.add_argument("path", nargs="?", default=None)
    pru.add_argument("--max-age-days", type=float, default=None,
                     help="drop entries recorded longer ago than this")
    pru.add_argument("--foreign", action="store_true",
                     help="drop entries keyed under a different host "
                     "fingerprint")
    pru.add_argument("--stale-schema", action="store_true",
                     help=f"drop entries keyed under a cache schema other "
                     f"than the current v{CACHE_VERSION}")
    args = ap.parse_args(argv)

    if args.cmd == "inspect":
        cache = PlanCache(args.path)
        entries = cache.entries()
        calib = cache.calibrations()
        if args.as_json:
            payload = {"version": CACHE_VERSION, "entries": entries}
            if calib:
                payload["calibration"] = calib
            print(json.dumps(payload, indent=1, sort_keys=True))
        else:
            now = time.time()
            print(f"# {cache.path}: {len(entries)} entr"
                  f"{'y' if len(entries) == 1 else 'ies'}")
            for key in sorted(entries):
                print(_format_entry(key, entries[key], now))
            for fp in sorted(calib):
                ent = calib[fp] if isinstance(calib[fp], dict) else {}
                print(f"calibration {fp}: {json.dumps(ent.get('constants'))}"
                      f" recorded={ent.get('recorded')}")
        return 0
    if args.cmd == "merge":
        out = merge_caches(args.out, args.inputs)
        print(f"# merged {len(args.inputs)} file(s) -> {out.path}: "
              f"{len(out)} entr{'y' if len(out) == 1 else 'ies'}")
        return 0
    # prune
    cache = PlanCache(args.path)
    try:
        removed = cache.prune(max_age_days=args.max_age_days,
                              foreign=args.foreign,
                              stale_schema=args.stale_schema)
    except ValueError as e:
        ap.error(str(e))
    for key in removed:
        print(f"# pruned {key}")
    print(f"# {cache.path}: removed {len(removed)}, kept {len(cache)}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
