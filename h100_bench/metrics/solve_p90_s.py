"""solve_p90_s: the 90th percentile of the window's per-solve times (host
clock, from the call to optimizer_from_problem to the synchronise after
optimize returns)."""

import statistics


def read(run):
    times = [r["solve_s"] for r in run.solves]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10, method="inclusive")[-1]
