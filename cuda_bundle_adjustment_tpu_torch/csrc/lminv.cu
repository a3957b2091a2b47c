// Kernels B4 and B10: the per-landmark 3x3 algebra of the Schur stage.
//
//   B4:  A = Hll[l] + lam I;  inv[l] = adj(A) / det(A);  y[l] = inv[l] . bl[l]
//        (lam read from device memory: one f64 the LM loop keeps on the card,
//        so that a CUDA graph that captured the launch reads each trial's
//        damping, and no host value is frozen into the graph)
//   B10: xl[l] = inv[l] . cl[l]
//
// with Hll and inv [La, 9] row-major symmetric 3x3 blocks and bl, y, cl, xl
// [La, 3], all in the working type T (double, or float in f32 mode; lam too).
// inv is the array the pair-product kernel (B6) and B10 read, y the vector
// kernel B5 reads.  In f32 the operands are converted to double as they are
// read, the arithmetic below is the f64 kernels' (B4's tile in shared memory
// stays in doubles), and each output is rounded to float once, at its store:
// y is formed from the unrounded inverse, as the twins do (kernels/_types.py).
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
// (12 in, 12 out: 25.6 MB a call at kitti00_mono, 0.0076 ms at 3.35 TB/s)
// against ~50 multiply-adds and one division, B10 moves 15 against 9
// multiply-adds.  So B4 is built to move its bytes coalesced and to do
// nothing else.
//
// B4 design: a block a tile of kTile = 128 landmarks, one launch a call, no
// atomics, the ragged last tile masked.
//   In:  the block copies the tile's 9 n Hll and 3 n bl entries into shared
//        memory, thread t taking entries t, t + kTile, ...; entry k of the
//        tile is row k / w, column k % w, read at base + row * ld + column
//        with the operand's own row stride ld (w = 9 or 3).  Neighbouring
//        threads read neighbouring addresses wherever the rows are packed:
//        the solver hands over Hll and bl as column blocks of B3's [La, 12]
//        rows (ld = 12), so a tile is one 12 KB span read by coalesced
//        8-byte loads at any offset, and no copy kernel runs before B4.
//   Compute: thread t inverts landmark t of the tile from its shared row
//        (13 doubles: Hll 0-8, bl 9-11, one pad; an odd stride, so a warp's
//        row reads fall on distinct banks) and leaves inv and y in its place.
//   Out: inv [La, 9] and y [La, 3] are contiguous, so the tile's outputs are
//        two spans written entry t + j kTile by thread t, coalesced.
// It replaces a thread-per-landmark kernel whose 8-byte loads and stores sat
// 72 and 24 bytes apart within a warp, behind two .contiguous() copies of the
// solver's views in its wrapper: three device kernels a call, 0.0333 ms on
// the device at kitti00_mono on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
// section 6 has the split and the new kernel's times).  B10's operands are
// contiguous outputs of B4 and B9 and it sits at its bound: it stays a thread
// per landmark.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // B10
constexpr int kTile = 128;     // B4: landmarks (and threads) a block
constexpr int kRow = 13;       // B4: doubles a landmark's shared row

template <typename T>
__global__ void __launch_bounds__(kTile)
damped_inverse_kernel(const T* __restrict__ hll, int64_t ldh,
                      const T* __restrict__ bl, int64_t ldb,
                      const T* __restrict__ lam_p, int64_t La,
                      T* __restrict__ inv, T* __restrict__ y) {
  __shared__ double s[kTile * kRow];
  const double lam = static_cast<double>(__ldg(lam_p));
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int n = static_cast<int>(La - base < kTile ? La - base : kTile);

  // all twelve loads of a thread issued before the first store to shared
  // memory, so that they are in flight together
  const T* h0 = hll + base * ldh;
  const T* b0 = bl + base * ldb;
  double hv[9], bv[3];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int k = t + j * kTile;
    if (k < 9 * n) hv[j] = h0[(k / 9) * ldh + k % 9];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int k = t + j * kTile;
    if (k < 3 * n) bv[j] = b0[(k / 3) * ldb + k % 3];
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int k = t + j * kTile;
    if (k < 9 * n) s[(k / 9) * kRow + k % 9] = hv[j];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int k = t + j * kTile;
    if (k < 3 * n) s[(k / 3) * kRow + 9 + k % 3] = bv[j];
  }
  __syncthreads();

  if (t < n) {
    double* r = s + t * kRow;
    // the twin adds lam * [1, 0, 0, 0, 1, 0, 0, 0, 1] to the whole block
    const double off = lam * 0.0;
    const double A00 = r[0] + lam, A01 = r[1] + off, A02 = r[2] + off;
    const double A11 = r[4] + lam, A12 = r[5] + off, A22 = r[8] + lam;

    const double det = A00 * A11 * A22 + A01 * A12 * A02 + A02 * A01 * A12 -
                       A00 * A12 * A12 - A02 * A11 * A02 - A01 * A01 * A22;
    const double inv_det = 1.0 / det;
    const double B00 = inv_det * (A11 * A22 - A12 * A12);
    const double B01 = inv_det * (A02 * A12 - A01 * A22);
    const double B11 = inv_det * (A00 * A22 - A02 * A02);
    const double B02 = inv_det * (A01 * A12 - A02 * A11);
    const double B12 = inv_det * (A02 * A01 - A00 * A12);
    const double B22 = inv_det * (A00 * A11 - A01 * A01);

    const double c0 = r[9], c1 = r[10], c2 = r[11];
    r[0] = B00; r[1] = B01; r[2] = B02;
    r[3] = B01; r[4] = B11; r[5] = B12;
    r[6] = B02; r[7] = B12; r[8] = B22;
    r[9] = B00 * c0 + B01 * c1 + B02 * c2;
    r[10] = B01 * c0 + B11 * c1 + B12 * c2;
    r[11] = B02 * c0 + B12 * c1 + B22 * c2;
  }
  __syncthreads();

  T* inv0 = inv + base * 9;
  T* y0 = y + base * 3;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int k = t + j * kTile;
    if (k < 9 * n) inv0[k] = static_cast<T>(s[(k / 9) * kRow + k % 9]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int k = t + j * kTile;
    if (k < 3 * n) y0[k] = static_cast<T>(s[(k / 3) * kRow + 9 + k % 3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym3x3_mv_kernel(const T* __restrict__ inv, const T* __restrict__ c,
                 int64_t La, T* __restrict__ x) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= La) return;
  const T* b = inv + l * 9;
  const double c0 = c[l * 3], c1 = c[l * 3 + 1], c2 = c[l * 3 + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double b0 = b[i * 3], b1 = b[i * 3 + 1], b2 = b[i * 3 + 2];
    x[l * 3 + i] = static_cast<T>(b0 * c0 + b1 * c1 + b2 * c2);
  }
}

template <typename T>
int damped_inverse(const void* hll, long long ldh, const void* bl, long long ldb,
                   const void* lam, long long La, void* inv, void* y, void* stream) {
  const long long blocks = (La + kTile - 1) / kTile;
  damped_inverse_kernel<T><<<static_cast<unsigned>(blocks), kTile, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(hll), ldh, static_cast<const T*>(bl), ldb,
      static_cast<const T*>(lam), La, static_cast<T*>(inv), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sym3x3_mv(const void* inv, const void* c, long long La, void* x, void* stream) {
  const long long blocks = (La + kThreads - 1) / kThreads;
  sym3x3_mv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inv), static_cast<const T*>(c), La, static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// inv [La, 9], y [La, 3] (kernel B4); Hll [La, 9] and bl [La, 3] with row
// strides ldh and ldb (in entries), their entries adjacent within a row; lam
// one value on the device.  f32: 1 where every operand is f32, 0 for f64.
extern "C" int tba_damped_inverse(const void* hll, long long ldh, const void* bl,
                                  long long ldb, const void* lam, long long La,
                                  int f32, void* inv, void* y, void* stream) {
  if (La == 0) return 0;
  return f32 ? damped_inverse<float>(hll, ldh, bl, ldb, lam, La, inv, y, stream)
             : damped_inverse<double>(hll, ldh, bl, ldb, lam, La, inv, y, stream);
}

// xl [La, 3] (kernel B10); f32 as above
extern "C" int tba_sym3x3_mv(const void* inv, const void* c, long long La, int f32,
                             void* x, void* stream) {
  if (La == 0) return 0;
  return f32 ? sym3x3_mv<float>(inv, c, La, x, stream)
             : sym3x3_mv<double>(inv, c, La, x, stream);
}
