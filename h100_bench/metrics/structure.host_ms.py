"""structure.host_ms: the program's time profile, stages "1: Build
Structure" and "5: Symbolic Decomposition", mean over the window's solves
(host clock, ms)."""


def read(run):
    return sum(r["structure_ms"] for r in run.solves) / len(run.solves) if run.solves else None
