#!/usr/bin/env python3
"""Where the time of the Schur-vector kernels B5 and B9 goes, at the first
linearisation of ``kitti00_mono`` on one CUDA card.

    python3 tools/schurvec_clock.py                     # the earlier kernels
    python3 tools/schurvec_clock.py --ablate [file.cu]  # the tile pass

Run from the repository root; it builds with ``nvcc`` into ``build/probe/``.

Without ``--ablate``: ``clock64()`` counters in a copy of the earlier
kernels (a warp a pose for B5, a thread a landmark for B9, each edge found
through the segment plan's ``order[]``).  For each kernel it prints one
JSON line: the mean cycles
a warp spends, per round of 32 edges (B5) or per edge (B9), fetching the
edge's indices (``order[j]`` then the other vertex), loading its Hpl row and
vector row, and multiplying; the warp's whole lifetime; how unequal the
warps' rounds are; the kernel's time with and without the counters; and,
beside them, a block that only streams its tile of 128 Hpl rows into shared
memory (the floor of a tile pass at these shapes).  A counter read waits for
the values it follows, so the probe serialises what the kernel overlaps:
read the split as shares, the uninstrumented time as the time.

With ``--ablate``: the tile-pass kernels of ``csrc/schurvec.cu`` (or of the
file given, with the same C interface), built as they are and with one
phase cut out at a time (:data:`ABLATIONS`), each timed as ``chip_smoke.py``
times ``device_ms``: what a phase costs is the time it takes away.  The cut
variants compute wrong values; only their times are read.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ unsigned long long bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}

// counters a warp (B5) or a thread (B9): index, rows, arithmetic, rounds,
// lifetime
constexpr int kCounters = 5;

// B5 as it was: a warp a pose, lane l takes the pose's edges l, l + 32, ...
template <bool kProbe>
__global__ void __launch_bounds__(128)
mv_kernel(const double* __restrict__ hpl, const double* __restrict__ y,
          const int64_t* __restrict__ lm_idx, const double* __restrict__ bp,
          const int64_t* __restrict__ order, const int64_t* __restrict__ offsets,
          int64_t Pa, int64_t La, double* __restrict__ out, long long* __restrict__ cnt) {
  const long long born = clk();
  const int64_t p = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= Pa) return;
  long long t_idx = 0, t_row = 0, t_mul = 0, rounds = 0;
  unsigned long long sink = 0;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int64_t end = offsets[p + 1];
  for (int64_t j = offsets[p] + lane; j < end; j += 32) {
    long long t0 = 0, t1 = 0, t2 = 0;
    if (kProbe) t0 = clk();
    const int64_t e = order[j];
    int64_t l = lm_idx[e];
    l = l < 0 ? 0 : (l < La ? l : La - 1);
    if (kProbe) {
      sink ^= static_cast<unsigned long long>(l);
      t1 = clk();
    }
    const double* h = hpl + e * 18;
    double hr[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) hr[k] = h[k];
    const double y0 = y[l * 3], y1 = y[l * 3 + 1], y2 = y[l * 3 + 2];
    if (kProbe) {
#pragma unroll
      for (int k = 0; k < 18; ++k) sink ^= bits(hr[k]);
      sink ^= bits(y0) ^ bits(y1) ^ bits(y2);
      t2 = clk();
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[i] += hr[i * 3] * y0 + hr[i * 3 + 1] * y1 + hr[i * 3 + 2] * y2;
    if (kProbe) {
      sink ^= bits(acc[5]);
      const long long t3 = clk();
      t_idx += t1 - t0;
      t_row += t2 - t1;
      t_mul += t3 - t2;
      ++rounds;
    }
  }
#pragma unroll
  for (int sh = 16; sh >= 1; sh >>= 1)
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[i] += __shfl_down_sync(0xffffffffu, acc[i], sh);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) out[p * 6 + i] = bp[p * 6 + i] - acc[i];
    if (kProbe) {
      long long* c = cnt + p * kCounters;
      c[0] = t_idx;
      c[1] = t_row;
      c[2] = t_mul + static_cast<long long>(sink & 1);
      c[3] = rounds;
      c[4] = clk() - born;
    }
  }
}

// B9 as it was: a thread a landmark, its edges in segment order
template <bool kProbe>
__global__ void __launch_bounds__(256)
mtv_kernel(const double* __restrict__ hpl, const double* __restrict__ xp,
           const int64_t* __restrict__ pose_idx, const double* __restrict__ bl,
           const int64_t* __restrict__ order, const int64_t* __restrict__ offsets,
           int64_t La, int64_t Pa, double* __restrict__ out, long long* __restrict__ cnt) {
  const long long born = clk();
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= La) return;
  long long t_idx = 0, t_row = 0, t_mul = 0, edges = 0;
  unsigned long long sink = 0;
  double acc[3] = {0.0, 0.0, 0.0};
  const int64_t end = offsets[l + 1];
  for (int64_t j = offsets[l]; j < end; ++j) {
    long long t0 = 0, t1 = 0, t2 = 0;
    if (kProbe) t0 = clk();
    const int64_t e = order[j];
    int64_t p = pose_idx[e];
    p = p < 0 ? 0 : (p < Pa ? p : Pa - 1);
    if (kProbe) {
      sink ^= static_cast<unsigned long long>(p);
      t1 = clk();
    }
    const double* h = hpl + e * 18;
    double hr[18], xv[6];
#pragma unroll
    for (int k = 0; k < 18; ++k) hr[k] = h[k];
#pragma unroll
    for (int c = 0; c < 6; ++c) xv[c] = xp[p * 6 + c];
    if (kProbe) {
#pragma unroll
      for (int k = 0; k < 18; ++k) sink ^= bits(hr[k]);
#pragma unroll
      for (int c = 0; c < 6; ++c) sink ^= bits(xv[c]);
      t2 = clk();
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      double s = hr[k] * xv[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) s += hr[c * 3 + k] * xv[c];
      acc[k] += s;
    }
    if (kProbe) {
      sink ^= bits(acc[2]);
      const long long t3 = clk();
      t_idx += t1 - t0;
      t_row += t2 - t1;
      t_mul += t3 - t2;
      ++edges;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[l * 3 + k] = bl[l * 3 + k] - acc[k];
  if (kProbe) {
    long long* c = cnt + l * kCounters;
    c[0] = t_idx;
    c[1] = t_row;
    c[2] = t_mul + static_cast<long long>(sink & 1);
    c[3] = edges;
    c[4] = clk() - born;
  }
}

// a tile pass's floor: a block brings its 128 Hpl rows to shared memory
// (nine 16-byte loads a thread) and keeps one word of them
__global__ void __launch_bounds__(128)
stream_kernel(const double* __restrict__ hpl, int64_t E, double* __restrict__ out) {
  __shared__ double s[128 * 19];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * 128;
  const int n = E - tile0 < 128 ? static_cast<int>(E - tile0) : 128;
  const double2* h2 = reinterpret_cast<const double2*>(hpl + tile0 * 18);
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    const int c = threadIdx.x + 128 * m;
    if (c < n * 9) {
      const double2 v = h2[c];
      const int r = c / 9, k = 2 * (c - 9 * r);
      s[r * 19 + k] = v.x;
      s[r * 19 + k + 1] = v.y;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = s[(blockIdx.x % n) * 19];
}

extern "C" int probe_mv(int probe, const void* hpl, const void* y, const void* idx,
                        const void* bp, const void* order, const void* offsets,
                        long long Pa, long long La, void* out, void* cnt, void* stream) {
  const unsigned blocks = static_cast<unsigned>((Pa + 3) / 4);
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<blocks, 128, 0, st>>>(
        static_cast<const double*>(hpl), static_cast<const double*>(y),
        static_cast<const int64_t*>(idx), static_cast<const double*>(bp),
        static_cast<const int64_t*>(order), static_cast<const int64_t*>(offsets), Pa, La,
        static_cast<double*>(out), static_cast<long long*>(cnt));
  };
  if (probe) args(mv_kernel<true>); else args(mv_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_mtv(int probe, const void* hpl, const void* xp, const void* idx,
                         const void* bl, const void* order, const void* offsets,
                         long long La, long long Pa, void* out, void* cnt, void* stream) {
  const unsigned blocks = static_cast<unsigned>((La + 255) / 256);
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<blocks, 256, 0, st>>>(
        static_cast<const double*>(hpl), static_cast<const double*>(xp),
        static_cast<const int64_t*>(idx), static_cast<const double*>(bl),
        static_cast<const int64_t*>(order), static_cast<const int64_t*>(offsets), La, Pa,
        static_cast<double*>(out), static_cast<long long*>(cnt));
  };
  if (probe) args(mtv_kernel<true>); else args(mtv_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_stream(const void* hpl, long long E, void* out, void* stream) {
  stream_kernel<<<static_cast<unsigned>((E + 127) / 128), 128, 0,
                  static_cast<cudaStream_t>(stream)>>>(static_cast<const double*>(hpl), E,
                                                       static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


# phase cut out -> (text of csrc/schurvec.cu, what replaces it)
ABLATIONS = {
    "as built": [],
    "no fences": [("__threadfence();", ";")],
    "no counters or finishing": [("if (!__syncthreads_or(shared_chunk)) return;", "return;")],
    "no chunk sums": [("  // the tile's chunks in segment order", "  return;\n  //")],
    "no vector gather": [("vec[k] = vr[k];", "vec[k] = 1.0 + 0.0 * other;")],
    "loads only": [("  double r[N];\n", "  return;\n  double r[N];\n")],
}


def ablations(path: Path) -> dict:
    """Build ``path`` and each of its :data:`ABLATIONS` (one ``nvcc`` each,
    side by side); returns the loaded libraries by name."""
    from concurrent.futures import ThreadPoolExecutor

    from cuda_bundle_adjustment_tpu_torch.kernels import _build, schurvec

    text = path.read_text()
    out = _build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)

    def one(item):
        k, (name, subs) = item
        src = text
        for old, new in subs:
            if old not in src:
                raise ValueError(f"ablation {name!r}: {old!r} is not in {path}")
            src = src.replace(old, new)
        cu, lib = out / f"ablate{k}.cu", out / f"libablate{k}-{path.stem}.so"
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build._flags("schurvec"), "-o", str(lib), str(cu)],
                       check=True)
        lib = ctypes.CDLL(str(lib))
        for fn, types in schurvec._ARGTYPES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        return name, lib

    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        return dict(pool.map(one, enumerate(ABLATIONS.items())))


def ablate(path: Path) -> int:
    import torch

    import chip_smoke as cs
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import (
        kitti00_scale_mixed_problem,
        kitti00_scale_problem,
    )
    from cuda_bundle_adjustment_tpu_torch.kernels import _build, lminv
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    libs = ablations(path)
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line())
    for label, problem in (("kitti00_mono", kitti00_scale_problem(kind="mono", seed=0)),
                           ("kitti00_mixed", kitti00_scale_mixed_problem(seed=0))):
        solver, sys_, lam = cs.first_linearisation(problem, dev)
        plan = solver.plan
        lp = plan.lin_plan
        _, y = lminv.damped_inverse(sys_.Hll, sys_.bl, lam)
        blocks, bsc, _ = bs.schur_reduce(sys_, lam, plan)
        xp, _ = bs.solve_reduced_band(blocks, bsc, plan)
        E, Pa, La = sys_.Hpl.shape[0], solver.Pa, solver.La
        bsc, cl = torch.empty_like(sys_.bp), torch.empty_like(sys_.bl)
        lm_scratch = lp.scratch.data_ptr() + 8 * 6 * lp.pose.chunks.shape[0]
        row = {}
        for name, lib in libs.items():
            def mv(lib=lib):
                _build.check(lib.tba_hpl_mv_segment_sum(
                    sys_.Hpl.data_ptr(), y.data_ptr(), plan.ba_lm_idx.data_ptr(),
                    sys_.bp.data_ptr(), sys_.bp.stride(0), *(t.data_ptr() for t in lp.pose),
                    lp.count.data_ptr(),
                    lp.scratch.data_ptr(), E, Pa, La, 0, bsc.data_ptr(), _build.stream_ptr(bsc)),
                    "mv")

            def mtv(lib=lib):
                _build.check(lib.tba_hpl_mtv_segment_sum(
                    sys_.Hpl.data_ptr(), xp.data_ptr(), plan.ba_pose_idx.data_ptr(),
                    sys_.bl.data_ptr(), sys_.bl.stride(0), *(t.data_ptr() for t in lp.lm),
                    lp.lm_slot.data_ptr(),
                    lp.count.data_ptr() + 4 * Pa, lm_scratch, E, La, Pa, 0, cl.data_ptr(),
                    _build.stream_ptr(cl)), "mtv")

            row[name] = dict(B5=round(cs.device_ms(mv), 4), B9=round(cs.device_ms(mtv), 4))
            lp.count.zero_()  # a cut variant may leave a counter above zero
        print(json.dumps(dict(source=str(path), input=label, device_ms=row)))
    return 0


def build():
    from cuda_bundle_adjustment_tpu_torch.kernels import _build

    out = _build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "schurvec_clock.cu", out / "libschurvec_clock.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build._flags("schurvec"), "-o", str(lib), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for fn in (lib.probe_mv, lib.probe_mtv):
        fn.argtypes = [ctypes.c_int] + [vp] * 6 + [ll, ll, vp, vp, vp]
        fn.restype = ctypes.c_int
    lib.probe_stream.argtypes = [vp, ll, vp, vp]
    lib.probe_stream.restype = ctypes.c_int
    return lib


def split(cnt, per: str) -> dict:
    """Mean cycles per warp and per ``per`` (round or edge) of each phase."""
    import torch

    c = cnt.double()
    n = c[:, 3].clamp(min=1)
    live = c[:, 3] > 0
    phase = {k: round(float((c[live, i] / n[live]).mean()), 1)
             for i, k in enumerate(("index fetch", "row loads", "multiply"))}
    return {f"cycles a {per}": phase,
            f"{per}s a warp": dict(mean=round(float(c[live, 3].mean()), 2),
                                   max=int(c[live, 3].max())),
            "warp lifetime cycles": dict(mean=round(float(c[live, 4].mean())),
                                         max=int(c[live, 4].max()),
                                         p50=int(torch.quantile(c[live, 4], 0.5)))}


def main() -> int:
    import torch

    import chip_smoke as cs
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import kitti00_scale_problem
    from cuda_bundle_adjustment_tpu_torch.kernels import _build, lminv, schurvec
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    if not torch.cuda.is_available():
        print("schurvec_clock: no CUDA device", file=sys.stderr)
        return 1
    if "--ablate" in sys.argv:
        rest = sys.argv[sys.argv.index("--ablate") + 1:]
        return ablate(Path(rest[0]) if rest else Path(schurvec.__file__).parents[1] / "csrc"
                      / "schurvec.cu")
    lib = build()
    dev = torch.device("cuda", 0)
    solver, sys_, lam = cs.first_linearisation(kitti00_scale_problem(kind="mono", seed=0), dev)
    plan = solver.plan
    _, y = lminv.damped_inverse(sys_.Hll, sys_.bl, lam)
    blocks, bsc, _ = bs.schur_reduce(sys_, lam, plan)
    xp, _ = bs.solve_reduced_band(blocks, bsc, plan)
    E = sys_.Hpl.shape[0]
    # the earlier kernels read bp and bl as [n, 6] and [n, 3] rows; the
    # solver's are column blocks of wider rows
    bp, bl = sys_.bp.contiguous(), sys_.bl.contiguous()
    rows = []
    for name, fn, vec, idx, base, seg, per, threads in (
        ("hpl_mv_segment_sum (B5, a warp a pose)", lib.probe_mv, y, plan.ba_lm_idx, bp,
         plan.pose_seg, "round", 32),
        ("hpl_mtv_segment_sum (B9, a thread a landmark)", lib.probe_mtv, xp, plan.ba_pose_idx,
         bl, plan.lm_seg, "edge", 1),
    ):
        V = base.shape[0]
        out = torch.empty_like(base)
        cnt = torch.zeros((V, 5), dtype=torch.int64, device=dev)

        def call(probe, fn=fn, vec=vec, idx=idx, base=base, seg=seg, out=out, cnt=cnt, V=V):
            _build.check(fn(probe, sys_.Hpl.data_ptr(), vec.data_ptr(), idx.data_ptr(),
                            base.data_ptr(), seg.order.data_ptr(), seg.offsets.data_ptr(), V,
                            vec.shape[0], out.data_ptr(), cnt.data_ptr(), _build.stream_ptr(out)),
                         name)

        call(1)
        torch.cuda.synchronize()
        probed = cnt.clone()
        if threads == 1:  # a thread a landmark: read the counters warp by warp
            w = probed[: V - V % 32].view(-1, 32, 5).double()
            probed = torch.cat([w[:, :, :4].sum(1) / 32, w[:, :, 4:].amax(1)], 1)
        call(0)
        want = (schurvec.hpl_mv_segment_sum_plain if threads == 32 else
                schurvec.hpl_mtv_segment_sum_plain)(sys_.Hpl, vec, idx, base, seg)
        err = ((out - want).abs().max() / want.abs().max()).item()
        rows.append(dict(
            kernel=name, rel_err_against_twin=err,
            ms=cs.cuda_ms(lambda: call(0)), device_ms=cs.device_ms(lambda: call(0)),
            ms_with_counters=cs.cuda_ms(lambda: call(1)), **split(probed, per),
        ))
    sink = torch.empty(-(-E // 128), dtype=torch.float64, device=dev)

    def stream():
        _build.check(lib.probe_stream(sys_.Hpl.data_ptr(), E, sink.data_ptr(),
                                      _build.stream_ptr(sink)), "stream")

    rows.append(dict(kernel="stream the Hpl tiles only (128 rows a block)",
                     ms=cs.cuda_ms(stream), device_ms=cs.device_ms(stream),
                     hpl_bytes=sys_.Hpl.numel() * 8,
                     median_edges_a_pose=statistics.median(
                         (plan.pose_seg.offsets[1:] - plan.pose_seg.offsets[:-1]).tolist())))
    print(cs.nvidia_smi_line())
    for r in rows:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
