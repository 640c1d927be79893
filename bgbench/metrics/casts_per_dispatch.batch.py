"""The bf16 route's storage casts per frame-engine dispatch: the program's
``cast`` counts (``plan.py::_cast``, inside its ``plan.cast`` spans) under
its ``engine.step`` roots in the traced window, over those roots, read from
``repro_torch.tracing.records()``. ``None`` where the run has no trace, the
program has no tracer or records no ``cast`` (a commit before the counter),
or its buffer dropped records."""
from harness import program


def read(run):
    snap = program._snapshot() if run.trace is not None else None
    if snap is None or snap[1]:
        return None
    recs = snap[0]
    lo, hi = run.trace.lo * 1e9, run.trace.hi * 1e9
    root_of = []
    for i, r in enumerate(recs):  # a parent is recorded before its children
        root_of.append(i if r.parent < 0 else root_of[r.parent])
    steps = {i for i, r in enumerate(recs)
             if r.parent < 0 and r.name == "engine.step" and lo <= r.start_ns and 0 <= r.end_ns <= hi}
    casts = sum(r.value for i, r in enumerate(recs) if r.name == "cast" and root_of[i] in steps)
    if not steps or not casts:
        return None
    return casts / len(steps)
