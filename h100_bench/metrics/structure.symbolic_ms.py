"""structure.symbolic_ms: the program span "structure/symbolic" (the native
symbolic pass and the sort of the triples, on a structure-cache miss alone),
mean over the window's solves (host clock, ms)."""

import readings


def read(run):
    return readings.span_ms(run, "structure/symbolic")
