// Kernels B7 and B8: banded block Cholesky factor and solve (f32).
//
// Storage (same contract as the JAX package): band row c*SB + d holds the
// upper 6x6 block (c, c+d) of the Jacobi-scaled reduced camera system,
// flat row-major, for 0 <= d < SB; the array has (Pa + SB) * SB rows so
// trailing updates past the last column land in slack rows.  After the
// factor, row d = 0 of column c holds inv(L_cc) and rows d >= 1 hold
// Lt_d = L_{(c+d),c}^T.  Per column c (right-looking):
//   L_cc L_cc^T = A_cc;   Lt_d = inv(L_cc) U_d;
//   U'_{(c+d2),(d1-d2)} -= Lt_d2^T Lt_d1   for 1 <= d2 <= d1 < SB.
//
// Replaces: cuda_bundle_adjustment_tpu/pallas/bandchol.py band_factor2
// (pallas_call at :412) and band_solve (pallas_call at :275).  On the TPU
// the whole band sits in VMEM and the column recurrence is a fori_loop with
// MXU products.  This card has no block-wide memory of that size (the band
// is ~3 MB at KITTI-00 scale, SB = 16), so the band stays in device memory
// and, being far below the 50 MB L2, in L2.
//
// Bound on this card: latency.  The recurrence over the Pa columns is
// sequential and each column's work is tiny (~4k f32 multiply-adds in the
// factor, ~400 in a solve), so the time is Pa times the latency of a few
// dependent L2 round trips and block barriers; bandwidth and FLOPs are idle.
//
// Design: one thread block walks the columns in order.  In the factor, the
// column's SB blocks are staged in shared memory, one thread does the 6x6
// Cholesky and the inverse of L_cc in registers, all threads form the Lt_d
// and apply the trailing update (each output element owned by one thread,
// so no atomics), with __syncthreads() between the phases.  In the solve,
// six threads do the 6x6 products and the rest apply the band pushes.  A
// non-SPD pivot gives inf/NaN (1/sqrt of a non-positive number), never a
// clamp: the caller's finiteness check then rejects the LM step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSB = 48;
constexpr int kFactorThreads = 512;
constexpr int kSolveThreads = 128;

// Cholesky of the symmetric 6x6 block A (lower triangle read) and the
// inverse of its lower factor, written row-major to inv_l.
__device__ void chol6_inv(const float* A, float* inv_l) {
  float D[36], L[36], inv[36];
#pragma unroll
  for (int q = 0; q < 36; ++q) {
    D[q] = A[q];
    L[q] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float r = 1.0f / sqrtf(D[k * 6 + k]);
#pragma unroll
    for (int i = k; i < 6; ++i) L[i * 6 + k] = D[i * 6 + k] * r;
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
#pragma unroll
      for (int j = k + 1; j <= i; ++j) D[i * 6 + j] -= L[i * 6 + k] * L[j * 6 + k];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float acc = (i == j) ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < i; ++k) acc -= L[i * 6 + k] * inv[k * 6 + j];
      inv[i * 6 + j] = acc / L[i * 6 + i];
    }
#pragma unroll
  for (int q = 0; q < 36; ++q) inv_l[q] = inv[q];
}

__global__ void __launch_bounds__(kFactorThreads)
band_factor_kernel(const float* __restrict__ band, float* __restrict__ out,
                   int Pa, int SB, int64_t nrows) {
  __shared__ float S[kMaxSB * 36];   // column c's stored blocks U_d
  __shared__ float Lt[kMaxSB * 36];  // inv(L_cc) at d = 0, Lt_d at d >= 1
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int64_t i = tid; i < nrows * 36; i += nt) out[i] = band[i];
  __syncthreads();

  const int nd = SB - 1;
  for (int c = 0; c < Pa; ++c) {
    float* strip = out + static_cast<int64_t>(c) * SB * 36;
    for (int i = tid; i < SB * 36; i += nt) S[i] = strip[i];
    __syncthreads();
    if (tid == 0) chol6_inv(S, Lt);
    __syncthreads();
    for (int i = 36 + tid; i < SB * 36; i += nt) {
      const int d = i / 36, ij = i - d * 36, r = ij / 6, col = ij - r * 6;
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) v += Lt[r * 6 + k] * S[d * 36 + k * 6 + col];
      Lt[i] = v;
    }
    __syncthreads();
    for (int i = tid; i < SB * 36; i += nt) strip[i] = Lt[i];
    for (int i = tid; i < nd * nd * 36; i += nt) {
      const int p = i / 36, ij = i - p * 36;
      const int d1 = p / nd + 1, d2 = p - (d1 - 1) * nd + 1;
      if (d2 > d1) continue;
      const int r = ij / 6, col = ij - r * 6;
      float u = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) u += Lt[d2 * 36 + k * 6 + r] * Lt[d1 * 36 + k * 6 + col];
      out[(static_cast<int64_t>(c + d2) * SB + (d1 - d2)) * 36 + ij] -= u;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSolveThreads)
band_solve_kernel(const float* __restrict__ L, const float* __restrict__ b,
                  float* __restrict__ x, int Pa, int SB, int bw) {
  __shared__ float v[6];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int64_t i = tid; i < static_cast<int64_t>(Pa) * 6; i += nt) x[i] = b[i];
  __syncthreads();

  // forward: y_c = inv(L_cc) b_c;  b_{c+d} -= Lt_d^T y_c
  for (int c = 0; c < Pa; ++c) {
    const float* strip = L + static_cast<int64_t>(c) * SB * 36;
    float* xc = x + static_cast<int64_t>(c) * 6;
    if (tid < 6) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += strip[tid * 6 + k] * xc[k];
      v[tid] = acc;
    }
    __syncthreads();
    if (tid < 6) xc[tid] = v[tid];
    const int nd = min(bw, Pa - 1 - c);
    for (int i = tid; i < nd * 6; i += nt) {
      const int d = i / 6 + 1, j = i - (d - 1) * 6;
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < 6; ++a) acc += strip[d * 36 + a * 6 + j] * v[a];
      xc[d * 6 + j] -= acc;
    }
    __syncthreads();
  }

  // backward: z = y_c - sum_d Lt_d x_{c+d};  x_c = inv(L_cc)^T z
  for (int c = Pa - 1; c >= 0; --c) {
    const float* strip = L + static_cast<int64_t>(c) * SB * 36;
    float* xc = x + static_cast<int64_t>(c) * 6;
    const int nd = min(bw, Pa - 1 - c);
    if (tid < 6) {
      float z = xc[tid];
      for (int d = 1; d <= nd; ++d)
#pragma unroll
        for (int j = 0; j < 6; ++j) z -= strip[d * 36 + tid * 6 + j] * xc[d * 6 + j];
      v[tid] = z;
    }
    __syncthreads();
    if (tid < 6) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) acc += strip[i * 6 + tid] * v[i];
      xc[tid] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tba_band_factor(const void* band, void* out, int Pa, int SB,
                               void* stream) {
  if (SB < 1 || SB > kMaxSB || Pa < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nrows = static_cast<int64_t>(Pa + SB) * SB;
  band_factor_kernel<<<1, kFactorThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(band), static_cast<float*>(out), Pa, SB, nrows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tba_band_solve(const void* L, const void* b, void* x, int Pa,
                              int SB, int bw, void* stream) {
  if (SB < 1 || SB > kMaxSB || bw < 0 || bw >= SB || Pa < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  band_solve_kernel<<<1, kSolveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(b),
      static_cast<float*>(x), Pa, SB, bw);
  return static_cast<int>(cudaGetLastError());
}
