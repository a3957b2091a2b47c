"""solve_s: the window's wall time over the solves completed in it (host
clock; on a mix that draws a graph a solve, the drawing is in the window)."""


def read(run):
    return run.window_s / len(run.solves) if run.solves else None
