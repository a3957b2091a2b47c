"""kernels.roofline_pct: the least time the card needs for the traced
solves' work (``work.py``: per stage, from the problem's shapes and the
linearisations and trials each solve made) over the device's busy time in
the trace, in percent."""


def read(run):
    t = run.trace
    if not t or not t.get("busy_s") or "work_s" not in t:
        return None
    return 100.0 * t["work_s"] / t["busy_s"]
