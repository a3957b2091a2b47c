#!/usr/bin/env python3
"""Device time of kernel B2 (``csrc/gather.cu``) built at several launch
shapes, at the shapes of ``kitti00_mono`` (``--city``: of the city-scale
graph, 4.18M edges) on one CUDA card.

    python3 tools/gather_variants.py [--earlier path/to/gather.cu] [--city]

Run from the repository root; it builds with ``nvcc`` into ``build/probe/``.
Each variant is ``csrc/gather.cu`` with ``kThreads`` and
``kChunksPerThread`` replaced, its grid capped at a number of blocks an SM
(the kernel's grid-stride loop then takes several trips) or not, and its
store plain or streaming (:data:`VARIANTS`); ``--earlier``
adds another source with the same C interface (``tba_gather_rows``), e.g.
the parent tree's.  Every build is
held bit for bit against ``table[idx]`` on the two tables the solver gathers
from (the pose state ``[P, 12]`` and the landmarks ``[L, 3]``, indices in
the solver's packed order), in f64 and f32, then timed as
``chip_smoke.py`` times ``device_ms``, the variants in turns (forward, then
backward) so that a drift of the card's clock falls on all of them alike.
Prints the card's name and power limit and one JSON line a variant: its
device ms at each of the four gathers, both turns, and the bytes bound; then
the card's own fill (``zero_``) and copy (``clone``) of each output's bytes,
the rates a write and a copy reach in practice.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

# (threads a block, 16-byte chunks a thread, blocks an SM of a grid that
# strides over the output or 0 for a grid that covers it, store: "cs", the
# streaming store __stcs of the source that marks the line first to evict
# from L2, or "plain")
VARIANTS = ((256, 1, 0, "plain"), (256, 2, 0, "plain"), (256, 1, 0, "cs"), (256, 2, 0, "cs"),
            (256, 4, 0, "cs"), (512, 2, 0, "cs"), (256, 1, 8, "cs"), (256, 2, 8, "cs"),
            (256, 4, 8, "cs"), (256, 2, 16, "cs"))
STORE = "__stcs(reinterpret_cast<C*>(out) + c, w[u]);"
GRID = "const unsigned blocks = (chunks + per_block - 1) / per_block;"
PROBE_DIR = Path("build/probe")


def variant_source(text: str, threads: int, chunks: int, per_sm: int, store: str,
                   sms: int = 132) -> str:
    out = text
    for name, value in (("kThreads", threads), ("kChunksPerThread", chunks)):
        out, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", out)
        if n != 1:
            raise SystemExit(f"gather.cu: {name} not found once")
    if out.count(STORE) != 1 or out.count(GRID) != 1:
        raise SystemExit("gather.cu: the store or the grid not found once")
    if per_sm:
        cover, cap = "(chunks + per_block - 1) / per_block", f"{sms * per_sm}u"
        out = out.replace(GRID, f"const unsigned blocks = {cover} < {cap} ? {cover} : {cap};")
    if store == "plain":
        out = out.replace(STORE, "reinterpret_cast<C*>(out)[c] = w[u];")
    return out


def build(name: str, text: str) -> ctypes.CDLL:
    from cuda_bundle_adjustment_tpu_torch.kernels import _build

    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = PROBE_DIR / f"{name}.cu", PROBE_DIR / f"lib{name}.so"
    src.write_text(text)
    subprocess.run([_build._nvcc(), *_build._flags("gather"), "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib.resolve())).tba_gather_rows
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    from chip_smoke import bound, device_ms, nvidia_smi_line
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import (
        city_scale_problem,
        kitti00_scale_problem,
    )
    from cuda_bundle_adjustment_tpu_torch.models.ba import _pose_state_table

    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", help="another gather.cu with the same C interface")
    ap.add_argument("--city", action="store_true", help="the city-scale graph's shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    text = Path("cuda_bundle_adjustment_tpu_torch/csrc/gather.cu").read_text()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sources = {f"t{t}_c{c}_sm{g}_{st}": variant_source(text, t, c, g, st, sms)
               for t, c, g, st in VARIANTS}
    if args.earlier:
        sources["earlier"] = Path(args.earlier).read_text()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources, sources.values())))

    problem = (city_scale_problem(kind="mono", seed=0, scale=1.0) if args.city
               else kitti00_scale_problem(kind="mono", seed=0))
    solver = optimizer_from_problem(problem).solver
    data, graph = solver.packed, solver.graph
    gathers = {}
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        gathers[f"pose_{tag}"] = (_pose_state_table(graph).to(dtype), data.pose_idx)
        gathers[f"landmark_{tag}"] = (graph.Xw.to(dtype), data.lm_idx)

    def call(fn, table, idx):
        M, K = table.shape
        out = torch.empty((idx.shape[0], K), dtype=table.dtype, device=table.device)
        status = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), M, idx.shape[0], K,
                    int(table.dtype == torch.float32), torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"CUDA error {status} at launch")
        return out

    for name, fn in libs.items():
        for what, (table, idx) in gathers.items():
            if not torch.equal(call(fn, table, idx), table[idx]):
                raise SystemExit(f"{name} {what}: not bit for bit table[idx]")
    times = {name: {what: [] for what in gathers} for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for what, (table, idx) in gathers.items():
                times[name][what].append(device_ms(lambda: call(libs[name], table, idx)))
    bounds = {what: bound((table, idx, table[idx]), 0, "f64")["bound_ms"]
              for what, (table, idx) in gathers.items()}
    for name in libs:
        print(json.dumps(dict(variant=name, device_ms=times[name], bound_ms=bounds)))
    # what the card's own fill and copy reach on an output of the same bytes:
    # a memset writes what the gather writes, a device-to-device copy reads
    # and writes it
    yard = {}
    for what, (table, idx) in gathers.items():
        shape, dt = (idx.shape[0], table.shape[1]), table.dtype
        src = table[idx]
        yard[what] = dict(
            fill_ms=device_ms(lambda: torch.empty(shape, dtype=dt, device="cuda").zero_()),
            copy_ms=device_ms(lambda: src.clone()),
            out_mb=src.numel() * src.element_size() / 1e6)
    print(json.dumps(dict(yardsticks=yard)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
