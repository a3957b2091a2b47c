// Kernel B6: Schur pair products, the reference's computeHschureKernel.
//
//   out[k] = sum_{t in block k} Hpl[ei_t] . invHll[lm(ei_t)] . Hpl[ej_t]^T
//
// for every 6x6 block k of the reduced camera system Hsc, over the symbolic
// triples (ei, ej) sorted by target block with CSR offsets [nnz + 1].  The
// caller negates the result and adds Hpp + lambda I on the diagonal.
//
// Replaces: cuda_bundle_adjustment_tpu/pallas/pairprod.py,
// _pairprod_call_v2 (pallas_call at :201), reached from schur_pair_rows_v2 /
// _pair_rows_from_splits.  On the TPU that kernel carries f64 as (hi, lo)
// f32 pairs through Dekker products and runs over the co-visibility group
// layout.  H100 has native f64, so this kernel works on plain doubles and
// walks the symbolic triple list directly.  As on the TPU, W = Hpl inv(Hll)
// is formed inside the kernel and never written to device memory.
//
// Bound on this card: f64 arithmetic and L2 latency.  At KITTI-00 scale
// there are ~1.7M triples into ~13.5k blocks: each triple reads 45 doubles
// (L2-resident: Hpl is 81 MB but accessed within a landmark's few edges)
// and does 162 f64 multiply-adds, ~0.28 GFLOP per call.
//
// Design: one warp per output block.  Lane l accumulates triples
// offsets[k] + l, + l + 32, ... in a fixed order, then a fixed shuffle tree
// sums the 32 partial blocks into lane 0.  No atomics, so the result is the
// same bit for bit on every run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
schur_pair_products_kernel(const double* __restrict__ hpl,
                           const double* __restrict__ inv_hll,
                           const int64_t* __restrict__ lm_idx,
                           const int64_t* __restrict__ tri_ei,
                           const int64_t* __restrict__ tri_ej,
                           const int64_t* __restrict__ offsets,
                           double* __restrict__ out, int64_t nnz) {
  const int64_t blk =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= nnz) return;  // uniform per warp: the whole warp leaves

  double acc[36];
#pragma unroll
  for (int q = 0; q < 36; ++q) acc[q] = 0.0;

  const int64_t end = offsets[blk + 1];
  for (int64_t t = offsets[blk] + lane; t < end; t += 32) {
    const int64_t ei = tri_ei[t];
    const int64_t ej = tri_ej[t];
    const double* a = hpl + ei * 18;
    const double* b = hpl + ej * 18;
    const double* m = inv_hll + lm_idx[ei] * 9;
    double mm[9], bb[18], w[18];
#pragma unroll
    for (int q = 0; q < 9; ++q) mm[q] = m[q];
#pragma unroll
    for (int q = 0; q < 18; ++q) bb[q] = b[q];
    // W = Hpl[ei] (6x3) @ invHll (3x3)
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const double a0 = a[i * 3], a1 = a[i * 3 + 1], a2 = a[i * 3 + 2];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        w[i * 3 + k] = a0 * mm[k] + a1 * mm[3 + k] + a2 * mm[6 + k];
    }
    // acc += W @ Hpl[ej]^T (6x6)
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
        acc[i * 6 + j] += w[i * 3] * bb[j * 3] + w[i * 3 + 1] * bb[j * 3 + 1] +
                          w[i * 3 + 2] * bb[j * 3 + 2];
  }

#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
#pragma unroll
    for (int q = 0; q < 36; ++q)
      acc[q] += __shfl_down_sync(0xffffffffu, acc[q], s);

  if (lane == 0) {
    double* o = out + blk * 36;
#pragma unroll
    for (int q = 0; q < 36; ++q) o[q] = acc[q];
  }
}

}  // namespace

extern "C" int tba_schur_pair_products(const void* hpl, const void* inv_hll,
                                       const void* lm_idx, const void* tri_ei,
                                       const void* tri_ej, const void* offsets,
                                       void* out, long long nnz, void* stream) {
  if (nnz == 0) return 0;
  const int threads = 32 * kWarpsPerBlock;
  const long long blocks = (nnz + kWarpsPerBlock - 1) / kWarpsPerBlock;
  schur_pair_products_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(hpl), static_cast<const double*>(inv_hll),
      static_cast<const int64_t*>(lm_idx), static_cast<const int64_t*>(tri_ei),
      static_cast<const int64_t*>(tri_ej), static_cast<const int64_t*>(offsets),
      static_cast<double*>(out), nnz);
  return static_cast<int>(cudaGetLastError());
}
