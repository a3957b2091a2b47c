"""packing.arrays_ms: the program span "pack/arrays" (the mono and stereo merge
and the pack's host NumPy work), mean over the window's solves (host clock,
ms)."""

import readings


def read(run):
    return readings.span_ms(run, "pack/arrays")
