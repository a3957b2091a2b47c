"""structure.digest_ms: the program span "structure/digest" (the structure
cache's SHA-256 of the index arrays, run inside packing), mean over the
window's solves (host clock, ms)."""

import readings


def read(run):
    return readings.span_ms(run, "structure/digest")
