"""loop.graph_reuse_pct: 100 x the mean over the window's solves of the fused
loop's counter reused (``opt.loop_stats``: 1 where the solve replayed the
loop that an earlier solve of its structure kept, else 0), in %."""

import readings


def read(run):
    reused = readings.loop_ms(run, "reused")
    return None if reused is None else 100.0 * reused
