// Kernels B5 and B9: the per-edge Hpl block-vector products of the Schur
// stage, summed per pose and per landmark.
//
//   B5: bsc[p] = bp[p] - sum over pose p's edges e of Hpl[e] . y[lm(e)]
//   B9: cl[l]  = bl[l] - sum over landmark l's edges e of Hpl[e]^T . xp[pose(e)]
//
// with Hpl [E, 18] row-major 6x3 blocks, y = inv(Hll) bl [La, 3] and the
// pose step xp [Pa, 6].  The index of the other vertex is clamped into
// range, as the plain twin clamps it: edges of fixed vertices have Hpl = 0.
//
// Replaces: cuda_bundle_adjustment_tpu/pallas/schurvec.py,
// hpl_mv_class_call (pallas_call at :128) and hpl_mtv_class_call
// (pallas_call at :152), the reference's computeBschure and
// schurComplementPost products.  The TPU kernels work on (hi, lo) f32 pairs
// over the co-visibility group layout and leave the bucket sums to XLA;
// here the products and the fixed-order sums are one kernel each, in f64.
//
// Arithmetic: the per-edge products in the plain twin's order
// (ops/components.py flat_mv_6x3, flat_mtv_6x3), built with -fmad=false
// (kernels/_build.py) so that they agree with the twin bit for bit: bsc and
// cl cancel much of their right-hand sides, where a contracted a * b + c
// would differ by an ulp of the terms.  The sums differ from the twin's only
// in order (B5's lanes and shuffle tree; B9 sums in the twin's order).
//
// Bound on this card: device-memory bytes.  Each edge reads its Hpl block
// (144 B), its index pair from the segment plan (16 B) and a row of y or xp
// (24 or 48 B, L2-resident); 6 or 3 outputs per vertex.  At KITTI-00 scale
// that is ~100 MB a call, against 2 x 18 f64 multiply-adds an edge.
//
// Design: B5 runs one warp per pose (about 420 edges at KITTI-00 scale):
// lane l takes the pose's edges l, l + 32, ... in segment order and a fixed
// shuffle tree sums the partials.  B9 runs one thread per landmark (about 4
// edges) in segment order.  The fixed order is the only order: no atomics,
// so two runs give the same result bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
hpl_mv_segment_sum_kernel(const double* __restrict__ hpl,
                          const double* __restrict__ y,
                          const int64_t* __restrict__ lm_idx,
                          const double* __restrict__ bp,
                          const int64_t* __restrict__ order,
                          const int64_t* __restrict__ offsets, int64_t Pa,
                          int64_t La, double* __restrict__ out) {
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= Pa) return;  // uniform per warp: the whole warp leaves

  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int64_t end = offsets[p + 1];
  for (int64_t j = offsets[p] + lane; j < end; j += 32) {
    const int64_t e = order[j];
    int64_t l = lm_idx[e];
    l = l < 0 ? 0 : (l < La ? l : La - 1);
    const double* h = hpl + e * 18;
    const double y0 = y[l * 3], y1 = y[l * 3 + 1], y2 = y[l * 3 + 2];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      acc[i] += h[i * 3] * y0 + h[i * 3 + 1] * y1 + h[i * 3 + 2] * y2;
  }

#pragma unroll
  for (int sh = 16; sh >= 1; sh >>= 1)
#pragma unroll
    for (int i = 0; i < 6; ++i)
      acc[i] += __shfl_down_sync(0xffffffffu, acc[i], sh);

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) out[p * 6 + i] = bp[p * 6 + i] - acc[i];
  }
}

__global__ void __launch_bounds__(kThreads)
hpl_mtv_segment_sum_kernel(const double* __restrict__ hpl,
                           const double* __restrict__ xp,
                           const int64_t* __restrict__ pose_idx,
                           const double* __restrict__ bl,
                           const int64_t* __restrict__ order,
                           const int64_t* __restrict__ offsets, int64_t La,
                           int64_t Pa, double* __restrict__ out) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= La) return;

  double acc[3] = {0.0, 0.0, 0.0};
  const int64_t end = offsets[l + 1];
  for (int64_t j = offsets[l]; j < end; ++j) {
    const int64_t e = order[j];
    int64_t p = pose_idx[e];
    p = p < 0 ? 0 : (p < Pa ? p : Pa - 1);
    const double* h = hpl + e * 18;
    const double* x = xp + p * 6;
    double xv[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) xv[c] = x[c];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      double s = h[k] * xv[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) s += h[c * 3 + k] * xv[c];
      acc[k] += s;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[l * 3 + k] = bl[l * 3 + k] - acc[k];
}

}  // namespace

// bsc [Pa, 6] (kernel B5)
extern "C" int tba_hpl_mv_segment_sum(const void* hpl, const void* y,
                                      const void* lm_idx, const void* bp,
                                      const void* order, const void* offsets,
                                      long long Pa, long long La, void* out,
                                      void* stream) {
  if (Pa == 0) return 0;
  const long long blocks = (Pa + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hpl_mv_segment_sum_kernel<<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock,
                              0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(hpl), static_cast<const double*>(y),
      static_cast<const int64_t*>(lm_idx), static_cast<const double*>(bp),
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(offsets),
      Pa, La, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// cl [La, 3] (kernel B9)
extern "C" int tba_hpl_mtv_segment_sum(const void* hpl, const void* xp,
                                       const void* pose_idx, const void* bl,
                                       const void* order, const void* offsets,
                                       long long La, long long Pa, void* out,
                                       void* stream) {
  if (La == 0) return 0;
  const long long blocks = (La + kThreads - 1) / kThreads;
  hpl_mtv_segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(hpl), static_cast<const double*>(xp),
      static_cast<const int64_t*>(pose_idx), static_cast<const double*>(bl),
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(offsets),
      La, Pa, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
