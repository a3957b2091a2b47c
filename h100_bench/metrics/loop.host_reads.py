"""loop.host_reads: the fused loop's host reads (``opt.loop_stats["reads"]``),
mean a solve over the window (a program counter)."""


def read(run):
    n = [r["reads"] for r in run.solves]
    if not n or any(v is None for v in n):
        return None
    return sum(n) / len(n)
