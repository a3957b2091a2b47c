"""The port's own readings of a run's solves: the span readings and the
fused loop's counters that each ``optimize()`` leaves in the port's
history (``cuda_bundle_adjustment_tpu_torch.utils.profiling.solve_history``).

The harness keeps no optimiser past its solve, so a reader finds the
window's solves there: the entries whose ``structure`` span equals, in
order, the ``structure_ms`` of the window's records (the same reading,
stages 1 + 5 of ``time_profile()``).  A port without that history, or one
whose entries do not match the records, gives nothing to read: the readers
return None."""

from __future__ import annotations

from typing import Optional


def _history() -> Optional[list]:
    try:
        from cuda_bundle_adjustment_tpu_torch.utils.profiling import solve_history
    except ImportError:
        return None
    return solve_history()


def _same(entry: dict, structure_ms: float) -> bool:
    s = entry["spans"].get("structure")
    return s is not None and abs(s - structure_ms) <= 1e-9 * max(1.0, abs(structure_ms))


def window(run) -> Optional[list]:
    """The history's entries of the window's solves, in the window's order;
    None where the history does not hold the window."""
    log, n = _history(), len(run.solves)
    if not log or not n:
        return None
    last = run.solves[-1]["structure_ms"]
    j = next((j for j in range(len(log) - 1, n - 2, -1) if _same(log[j], last)), None)
    if j is None:
        return None
    got = log[j - n + 1: j + 1]
    if not all(_same(e, r["structure_ms"]) for e, r in zip(got, run.solves)):
        return None
    return got


def span_ms(run, name: str) -> Optional[float]:
    """The span ``name``'s ms a window solve, mean over the window (a solve
    that did not run it reads 0); None where no window solve ran it."""
    got = window(run)
    if got is None:
        return None
    ms = [e["spans"].get(name) for e in got]
    if all(v is None for v in ms):
        return None
    return sum(v or 0.0 for v in ms) / len(ms)


def loop_ms(run, key: str) -> Optional[float]:
    """The fused loop's counter ``key`` (``loop_stats``), mean over the
    window's solves; None where a solve has none."""
    got = window(run)
    if got is None:
        return None
    v = [(e["loop"] or {}).get(key) for e in got]
    return None if any(x is None for x in v) else sum(v) / len(v)
