"""Points where the host blocked on the card, per frame-engine dispatch: the
program's ``sync`` counts under its ``engine.step`` spans in the traced
window, over the dispatches."""
from harness.program import syncs_per_root


def read(run):
    return syncs_per_root(run, "engine.step")
