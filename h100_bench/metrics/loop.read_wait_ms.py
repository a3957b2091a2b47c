"""loop.read_wait_ms: the fused loop's counter read_wait_ms
(``opt.loop_stats``, the reading of its span "loop/read"): the host's waits
in its flag reads and its trace read, mean over the window's solves (host
clock, ms)."""

import readings


def read(run):
    return readings.loop_ms(run, "read_wait_ms")
