"""Entry point ``frame_engine_stated``: ``frame_engine``'s closed loop on a
plan in the precision the configuration states. ``frame_engine.drive``
passes the caller's ``precision`` to ``plan_for`` as it is (``None``: the
program's default, fp32), so a configuration's own ``"precision"`` is never
read there; this entry loads ``frame_engine.py`` with
``harness.spec.load_module`` and calls its ``drive`` with ``precision or
run.config["precision"]``: a caller's precision still wins. ``check`` is
``frame_engine``'s, re-exported.

Mix parameters: ``frame_engine``'s.
"""
from __future__ import annotations

from pathlib import Path

from harness.spec import load_module

_loop = load_module(Path(__file__).resolve().with_name("frame_engine.py"),
                    "bgbench_entry_frame_engine_stated_loop")
check = _loop.check


def drive(run, pool, seed, seconds, device, precision, tracer, t_start):
    return _loop.drive(run, pool, seed, seconds, device, precision or run.config["precision"],
                       tracer, t_start)
