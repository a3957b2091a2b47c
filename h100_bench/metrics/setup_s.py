"""setup_s: from the start of the benchmark's process to the start of the
window (host clock): imports, the CUDA context, the kernel builds of a cold
checkout, the graph made from the seed and the warm-up solve."""


def read(run):
    return run.setup_s
