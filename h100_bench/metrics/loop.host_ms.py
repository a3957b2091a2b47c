"""loop.host_ms: the fused loop's counters eager_ms + capture_ms
(``opt.loop_stats``), mean over the window's solves (host clock, ms)."""


def read(run):
    ms = [r["loop_host_ms"] for r in run.solves]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(ms)
