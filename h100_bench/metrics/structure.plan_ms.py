"""structure.plan_ms: the program span "structure/plan" (make_schur_plan: the
segment, B3 and B6 plans made and uploaded, on a structure-cache miss
alone), mean over the window's solves (host clock, ms)."""

import readings


def read(run):
    return readings.span_ms(run, "structure/plan")
