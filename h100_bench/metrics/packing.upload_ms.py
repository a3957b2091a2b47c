"""packing.upload_ms: the program span "pack/upload" (the state's and the
edges' copies to the device from pageable host memory, and the masks made
there), mean over the window's solves (host clock, ms)."""

import readings


def read(run):
    return readings.span_ms(run, "pack/upload")
