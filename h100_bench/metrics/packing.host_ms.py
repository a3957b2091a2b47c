"""packing.host_ms: the harness's span round optimizer_from_problem, ended
by a synchronise, mean over the window's solves (host clock, ms)."""


def read(run):
    return sum(r["pack_ms"] for r in run.solves) / len(run.solves) if run.solves else None
