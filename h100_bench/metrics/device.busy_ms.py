"""device.busy_ms: the union of the device operations' intervals (kernels,
copies, sets) in the torch.profiler trace of the traced solves, mean a
solve, ms."""


def read(run):
    t = run.trace
    if not t or not t.get("busy_s"):
        return None
    return 1e3 * t["busy_s"] / t["solves"]
