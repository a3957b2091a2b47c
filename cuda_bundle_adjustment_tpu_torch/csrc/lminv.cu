// Kernels B4 and B10: the per-landmark 3x3 algebra of the Schur stage.
//
//   B4:  A = Hll[l] + lam I;  inv[l] = adj(A) / det(A);  y[l] = inv[l] . bl[l]
//   B10: xl[l] = inv[l] . cl[l]
//
// with Hll and inv [La, 9] row-major symmetric 3x3 blocks and bl, y, cl, xl
// [La, 3], all f64.  inv is the array the pair-product kernel (B6) and B10
// read, y the vector kernel B5 reads.
//
// Replaces: cuda_bundle_adjustment_tpu/pallas/lminv.py, lminv_call
// (pallas_call at :169) and sym3x3_mv_call (pallas_call at :206), the
// reference's device Hll inversion and the landmark back-substitution
// product.  The TPU kernels work on (hi, lo) f32 pairs over component-major
// [k, La] lane rows padded to 128 lanes, with a guarded double-float
// reciprocal because the padding slots hold zero blocks.  Here there is no
// padding and f64 is native: the damped block is inverted as it stands, and
// lam > 0 on every LM trial keeps a zero Hll block invertible (lam I).
//
// Arithmetic: ops/components.py flat_sym3x3_inv and flat_mv_3x3, operation
// for operation in their order (the six-term determinant left to right,
// inv_det * (cofactor), three products and two sums per output row), built
// with -fmad=false (kernels/_build.py), so both kernels agree with their
// plain twins bit for bit.
//
// Bound on this card: device-memory bytes.  B4 moves 24 doubles a landmark
// (12 in, 12 out) against ~50 multiply-adds and one division, B10 moves 15
// against 9 multiply-adds.
//
// Design: one thread per landmark.  A warp's loads and stores of the [La, 9]
// and [La, 3] rows are strided by 72 and 24 bytes, so sectors are shared
// between neighbouring threads through L1 rather than in one coalesced
// access; a staged, warp-cooperative copy is the known next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
damped_inverse_kernel(const double* __restrict__ hll,
                      const double* __restrict__ bl, double lam, int64_t La,
                      double* __restrict__ inv, double* __restrict__ y) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= La) return;
  const double* h = hll + l * 9;
  // the twin adds lam * [1, 0, 0, 0, 1, 0, 0, 0, 1] to the whole block
  const double off = lam * 0.0;
  const double A00 = h[0] + lam, A01 = h[1] + off, A02 = h[2] + off;
  const double A11 = h[4] + lam, A12 = h[5] + off, A22 = h[8] + lam;

  const double det = A00 * A11 * A22 + A01 * A12 * A02 + A02 * A01 * A12 -
                     A00 * A12 * A12 - A02 * A11 * A02 - A01 * A01 * A22;
  const double inv_det = 1.0 / det;
  const double B00 = inv_det * (A11 * A22 - A12 * A12);
  const double B01 = inv_det * (A02 * A12 - A01 * A22);
  const double B11 = inv_det * (A00 * A22 - A02 * A02);
  const double B02 = inv_det * (A01 * A12 - A02 * A11);
  const double B12 = inv_det * (A02 * A01 - A00 * A12);
  const double B22 = inv_det * (A00 * A11 - A01 * A01);

  double* o = inv + l * 9;
  o[0] = B00; o[1] = B01; o[2] = B02;
  o[3] = B01; o[4] = B11; o[5] = B12;
  o[6] = B02; o[7] = B12; o[8] = B22;

  const double b0 = bl[l * 3], b1 = bl[l * 3 + 1], b2 = bl[l * 3 + 2];
  y[l * 3] = B00 * b0 + B01 * b1 + B02 * b2;
  y[l * 3 + 1] = B01 * b0 + B11 * b1 + B12 * b2;
  y[l * 3 + 2] = B02 * b0 + B12 * b1 + B22 * b2;
}

__global__ void __launch_bounds__(kThreads)
sym3x3_mv_kernel(const double* __restrict__ inv, const double* __restrict__ c,
                 int64_t La, double* __restrict__ x) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= La) return;
  const double* b = inv + l * 9;
  const double c0 = c[l * 3], c1 = c[l * 3 + 1], c2 = c[l * 3 + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[l * 3 + i] = b[i * 3] * c0 + b[i * 3 + 1] * c1 + b[i * 3 + 2] * c2;
}

}  // namespace

// inv [La, 9], y [La, 3] (kernel B4)
extern "C" int tba_damped_inverse(const void* hll, const void* bl, double lam,
                                  long long La, void* inv, void* y,
                                  void* stream) {
  if (La == 0) return 0;
  const long long blocks = (La + kThreads - 1) / kThreads;
  damped_inverse_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(hll), static_cast<const double*>(bl), lam, La,
      static_cast<double*>(inv), static_cast<double*>(y));
  return static_cast<int>(cudaGetLastError());
}

// xl [La, 3] (kernel B10)
extern "C" int tba_sym3x3_mv(const void* inv, const void* c, long long La,
                             void* x, void* stream) {
  if (La == 0) return 0;
  const long long blocks = (La + kThreads - 1) / kThreads;
  sym3x3_mv_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(inv), static_cast<const double*>(c), La,
      static_cast<double*>(x));
  return static_cast<int>(cudaGetLastError());
}
