"""structure.order_ms: the program span "structure/order" (the RCM pose order,
run inside packing on a structure-cache miss alone), mean over the window's
solves (host clock, ms)."""

import readings


def read(run):
    return readings.span_ms(run, "structure/order")
