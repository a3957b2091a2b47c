"""device.idle_pct: 100 x (1 - the device's busy time / the traced solves'
wall time), both from the same torch.profiler trace and both inside the
harness's ``bench/solve`` spans (the client's drawing between solves is
left out).  The trace records the device and, on the host, the CUDA
runtime's calls and the harness's spans alone; it still lengthens a solve
(the run's earlier lines give a traced solve's time beside an untraced
one's)."""


def read(run):
    t = run.trace
    if not t or not t.get("busy_s") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
