"""Run one cell of the H100 benchmark of ``cuda_bundle_adjustment_tpu_torch``.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Earlier lines of standard output describe the
machine and the run; the last line is the result, one JSON object.  The last
lines of standard error are the numbers the comparison with the reference
read, each beside its limit.  A run needs a CUDA card: without one it exits
with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

# top-level module names that no process of the benchmark may hold: JAX and
# the JAX package (the port's name begins with the latter's, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_bundle_adjustment_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2

    import devtrace
    import harness

    print(devtrace.card_line(), flush=True)
    print(f"{devtrace.host_line()}; Python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.get_num_threads()} intra-op threads", flush=True)
    result, checks = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                      bool(args.trace), "cuda", T_START,
                                      log=lambda s: print(s, flush=True))
    print(f"memory peak {result['device']['memory_peak_bytes']} bytes; "
          f"{devtrace.card_line()}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark may not load were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
