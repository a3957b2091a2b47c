// Kernels B1 (per-edge chi) and B3 (fused linearisation) of the mono and
// stereo BA models, the reference's computeActiveErrorsKernel and
// constructQuadraticFormKernel.
//
//   B1: chi[e] = omega * active * |e|^2  (rk = 0; e = proj - meas)
//   B3: Hpp|bp [Pa, 42] = sum over a pose's edges of w JP^T JP | w JP^T e,
//       Hll|bl [La, 12] = sum over a landmark's edges of w JL^T JL | w JL^T e,
//       Hpl [E, 18]     = w both_free JP^T JL per edge,
//   with w = omega * active and the g2o convention J = -d(proj)/d(state).
//
// Replaces: cuda_bundle_adjustment_tpu/pallas/terms.py, chi_class_call
// (pallas_call at :549) and terms_class_call (pallas_call at :461).  The TPU
// kernels carry f64 as (hi, lo) f32 pairs through Dekker products, run over
// the co-visibility group layout one class at a time, and leave single-free
// edges to an XLA tail.  H100 has native f64, so these kernels compute in
// plain doubles over the edges as packed, and see every edge: Hpl carries the
// both_free factor itself, as the plain twin does (models/ba.py).
//
// Arithmetic: the expressions of the plain twin (ops/components.py and
// models/ba.py) operation for operation, mono rows with the mono Jacobian
// (MDIM 2), stereo and merged mono+stereo rows with the stereo Jacobian and
// the third row masked by m3 (MDIM 3).  The file is built with -fmad=false
// (kernels/_build.py): the residual proj - meas cancels terms as large as the
// projected pixel coordinates, and a contracted a * b + c rounds differently
// from the twin by up to an ulp of those terms.  So per-edge values (chi, the
// Hpl blocks) agree with the twin bit for bit and the per-vertex sums differ
// only by summation order.  The guard |z| > 1e-30 times active gives an
// exact zero inv_z on inert and degenerate rows: inert rows (w = 0) give exact
// zeros everywhere, degenerate rows give zero JL and so zero Hll|bl and Hpl.
//
// Bound on this card: device-memory bytes.  An edge reads its gathered pose
// state (96 B), landmark (24 B), measurement (16-24 B) and masks (8-24 B);
// the f64 math (~300 flops an edge) is far below the card's f64 rate.  At
// KITTI-00 scale (E = 560k) B1 moves ~90 MB and B3 ~400 MB over its three
// passes.
//
// Design: B1 and the Hpl pass run one thread per edge.  Hpp|bp runs one warp
// per pose over the edges the pose segment plan sorts to it (about 420 at
// KITTI-00 scale): lane l takes the pose's edges l, l + 32, ... in a fixed
// order and a fixed shuffle tree sums the 32 partials.  Hll|bl runs one
// thread per landmark (about 4 edges) in segment order.  Each pass re-derives
// the edge's residual and Jacobian from the inputs instead of reading an
// [E, 42] scratch written by another pass, which costs more bytes than the
// arithmetic.  No atomics: two runs give the same result bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = 4;

// What a per-edge evaluation reads.  A null mask reads as 1 (active,
// both_free) or as no mask (m3).
struct EdgeInputs {
  const double* qt;         // [E, 12] per-edge pose state t | R (row-major)
  const double* xw;         // [E, 3] per-edge landmark
  const double* meas;       // [MDIM, E]
  const double* omega;      // [1] or [E]
  const double* active;     // [E] or null
  const double* both_free;  // [E] or null
  const double* m3;         // [E] or null
  const double* cam;        // [5]: fx fy cx cy bf
  int64_t E;
  int omega_stride;  // 0: one weight for every edge, 1: one per edge
};

template <int MDIM>
struct Edge {
  double R[9];
  double Xx, Xy, inv_z;
  double e[MDIM];
  double w;   // omega * active
  double m3;  // third-row mask (1 without a mask)
};

template <int MDIM>
__device__ __forceinline__ void load_edge(const EdgeInputs& in, int64_t i,
                                          Edge<MDIM>& g) {
  const double* s = in.qt + i * 12;
  const double* X = in.xw + i * 3;
  const double fx = in.cam[0], fy = in.cam[1], cx = in.cam[2],
               cy = in.cam[3], bf = in.cam[4];
#pragma unroll
  for (int k = 0; k < 9; ++k) g.R[k] = s[3 + k];
  const double X0 = X[0], X1 = X[1], X2 = X[2];
  const double* R = g.R;
  g.Xx = R[0] * X0 + R[1] * X1 + R[2] * X2 + s[0];
  g.Xy = R[3] * X0 + R[4] * X1 + R[5] * X2 + s[1];
  const double z = R[6] * X0 + R[7] * X1 + R[8] * X2 + s[2];
  const double act = in.active ? in.active[i] : 1.0;
  g.inv_z = act * (fabs(z) > 1e-30 ? 1.0 / z : 0.0);
  g.w = in.omega[in.omega_stride ? i : 0] * act;
  g.m3 = in.m3 ? in.m3[i] : 1.0;
  const double u = fx * g.inv_z * g.Xx + cx;
  g.e[0] = u - in.meas[i];
  g.e[1] = fy * g.inv_z * g.Xy + cy - in.meas[in.E + i];
  if constexpr (MDIM == 3)
    g.e[2] = (u - bf * g.inv_z - in.meas[2 * in.E + i]) * g.m3;
}

// JP [MDIM][6] (ops/components.py mono_ / stereo_jacobian_comps)
template <int MDIM>
__device__ __forceinline__ void pose_jacobian(const double* cam,
                                              const Edge<MDIM>& g,
                                              double JP[MDIM][6]) {
  const double fx = cam[0], fy = cam[1];
  const double Xx = g.Xx, Xy = g.Xy, inv_z = g.inv_z;
  if constexpr (MDIM == 2) {
    const double x = inv_z * Xx, y = inv_z * Xy;
    const double fx_iz = fx * inv_z, fy_iz = fy * inv_z;
    JP[0][0] = fx * x * y;
    JP[0][1] = -fx * (1 + x * x);
    JP[0][2] = fx * y;
    JP[0][3] = -fx_iz;
    JP[0][4] = 0.0;
    JP[0][5] = fx_iz * x;
    JP[1][0] = fy * (1 + y * y);
    JP[1][1] = -fy * x * y;
    JP[1][2] = -fy * x;
    JP[1][3] = 0.0;
    JP[1][4] = -fy_iz;
    JP[1][5] = fy_iz * y;
  } else {
    const double bf = cam[4];
    const double inv_zz = inv_z * inv_z;
    JP[0][0] = Xx * Xy * inv_zz * fx;
    JP[0][1] = -(1 + Xx * Xx * inv_zz) * fx;
    JP[0][2] = Xy * inv_z * fx;
    JP[0][3] = -inv_z * fx;
    JP[0][4] = 0.0;
    JP[0][5] = Xx * inv_zz * fx;
    JP[1][0] = (1 + Xy * Xy * inv_zz) * fy;
    JP[1][1] = -Xx * Xy * inv_zz * fy;
    JP[1][2] = -Xx * inv_z * fy;
    JP[1][3] = 0.0;
    JP[1][4] = -inv_z * fy;
    JP[1][5] = Xy * inv_zz * fy;
    JP[2][0] = (JP[0][0] - bf * Xy * inv_zz) * g.m3;
    JP[2][1] = (JP[0][1] + bf * Xx * inv_zz) * g.m3;
    JP[2][2] = JP[0][2] * g.m3;
    JP[2][3] = JP[0][3] * g.m3;
    JP[2][4] = 0.0;
    JP[2][5] = (JP[0][5] - bf * inv_zz) * g.m3;
  }
}

// JL [MDIM][3]
template <int MDIM>
__device__ __forceinline__ void landmark_jacobian(const double* cam,
                                                  const Edge<MDIM>& g,
                                                  double JL[MDIM][3]) {
  const double fx = cam[0], fy = cam[1];
  const double* R = g.R;
  const double inv_z = g.inv_z;
  if constexpr (MDIM == 2) {
    const double x = inv_z * g.Xx, y = inv_z * g.Xy;
    const double fx_iz = fx * inv_z, fy_iz = fy * inv_z;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      JL[0][j] = -fx_iz * (R[j] - x * R[6 + j]);
      JL[1][j] = -fy_iz * (R[3 + j] - y * R[6 + j]);
    }
  } else {
    const double bf = cam[4];
    const double inv_zz = inv_z * inv_z;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      JL[0][j] = -fx * R[j] * inv_z + fx * g.Xx * R[6 + j] * inv_zz;
      JL[1][j] = -fy * R[3 + j] * inv_z + fy * g.Xy * R[6 + j] * inv_zz;
      JL[2][j] = (JL[0][j] - bf * R[6 + j] * inv_zz) * g.m3;
    }
  }
}

template <int MDIM>
__global__ void __launch_bounds__(kThreads)
chi_edges_kernel(EdgeInputs in, double* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= in.E) return;
  Edge<MDIM> g;
  load_edge<MDIM>(in, i, g);
  double s = g.e[0] * g.e[0] + g.e[1] * g.e[1];
  if constexpr (MDIM == 3) s += g.e[2] * g.e[2];
  const double act = in.active ? in.active[i] : 1.0;
  out[i] = in.omega[in.omega_stride ? i : 0] * s * act;
}

template <int MDIM>
__global__ void __launch_bounds__(kThreads)
hpl_kernel(EdgeInputs in, double* __restrict__ hpl) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= in.E) return;
  Edge<MDIM> g;
  load_edge<MDIM>(in, i, g);
  double JP[MDIM][6], JL[MDIM][3];
  pose_jacobian<MDIM>(in.cam, g, JP);
  landmark_jacobian<MDIM>(in.cam, g, JL);
  const double wb = g.w * (in.both_free ? in.both_free[i] : 1.0);
  double* o = hpl + i * 18;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      double s = JP[0][a] * JL[0][b];
#pragma unroll
      for (int m = 1; m < MDIM; ++m) s += JP[m][a] * JL[m][b];
      o[a * 3 + b] = s * wb;
    }
}

// upper-triangle position of (a, b), a <= b, in an n x n symmetric block
__host__ __device__ constexpr int tri6(int a, int b) { return a * (11 - a) / 2 + b; }
__host__ __device__ constexpr int tri3(int a, int b) { return a * (5 - a) / 2 + b; }

template <int MDIM>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
pose_blocks_kernel(EdgeInputs in, const int64_t* __restrict__ order,
                   const int64_t* __restrict__ offsets, int64_t Pa,
                   double* __restrict__ out) {
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= Pa) return;  // uniform per warp: the whole warp leaves

  double acc[27];  // 21 upper-triangle Hpp entries, then 6 bp
#pragma unroll
  for (int q = 0; q < 27; ++q) acc[q] = 0.0;

  const int64_t end = offsets[p + 1];
  for (int64_t j = offsets[p] + lane; j < end; j += 32) {
    const int64_t i = order[j];
    Edge<MDIM> g;
    load_edge<MDIM>(in, i, g);
    double JP[MDIM][6];
    pose_jacobian<MDIM>(in.cam, g, JP);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) {
        double s = JP[0][a] * JP[0][b];
#pragma unroll
        for (int m = 1; m < MDIM; ++m) s += JP[m][a] * JP[m][b];
        acc[tri6(a, b)] += g.w * s;
      }
      double s = JP[0][a] * g.e[0];
#pragma unroll
      for (int m = 1; m < MDIM; ++m) s += JP[m][a] * g.e[m];
      acc[21 + a] += g.w * s;
    }
  }

#pragma unroll
  for (int sh = 16; sh >= 1; sh >>= 1)
#pragma unroll
    for (int q = 0; q < 27; ++q)
      acc[q] += __shfl_down_sync(0xffffffffu, acc[q], sh);

  if (lane == 0) {
    double* o = out + p * 42;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = 0; b < 6; ++b)
        o[a * 6 + b] = acc[a <= b ? tri6(a, b) : tri6(b, a)];
#pragma unroll
    for (int a = 0; a < 6; ++a) o[36 + a] = acc[21 + a];
  }
}

template <int MDIM>
__global__ void __launch_bounds__(kThreads)
landmark_blocks_kernel(EdgeInputs in, const int64_t* __restrict__ order,
                       const int64_t* __restrict__ offsets, int64_t La,
                       double* __restrict__ out) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= La) return;

  double acc[9];  // 6 upper-triangle Hll entries, then 3 bl
#pragma unroll
  for (int q = 0; q < 9; ++q) acc[q] = 0.0;

  const int64_t end = offsets[l + 1];
  for (int64_t j = offsets[l]; j < end; ++j) {
    const int64_t i = order[j];
    Edge<MDIM> g;
    load_edge<MDIM>(in, i, g);
    double JL[MDIM][3];
    landmark_jacobian<MDIM>(in.cam, g, JL);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = a; b < 3; ++b) {
        double s = JL[0][a] * JL[0][b];
#pragma unroll
        for (int m = 1; m < MDIM; ++m) s += JL[m][a] * JL[m][b];
        acc[tri3(a, b)] += g.w * s;
      }
      double s = JL[0][a] * g.e[0];
#pragma unroll
      for (int m = 1; m < MDIM; ++m) s += JL[m][a] * g.e[m];
      acc[6 + a] += g.w * s;
    }
  }

  double* o = out + l * 12;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      o[a * 3 + b] = acc[a <= b ? tri3(a, b) : tri3(b, a)];
#pragma unroll
  for (int a = 0; a < 3; ++a) o[9 + a] = acc[6 + a];
}

unsigned blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

template <int MDIM>
void launch_chi(const EdgeInputs& in, double* out, cudaStream_t st) {
  chi_edges_kernel<MDIM><<<blocks_for(in.E, kThreads), kThreads, 0, st>>>(in, out);
}

template <int MDIM>
cudaError_t launch_linearise(const EdgeInputs& in, const int64_t* pose_order,
                             const int64_t* pose_offsets, int64_t Pa,
                             const int64_t* lm_order,
                             const int64_t* lm_offsets, int64_t La,
                             double* pose_out, double* lm_out, double* hpl,
                             cudaStream_t st) {
  if (in.E > 0) {
    hpl_kernel<MDIM><<<blocks_for(in.E, kThreads), kThreads, 0, st>>>(in, hpl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Pa > 0) {
    pose_blocks_kernel<MDIM>
        <<<blocks_for(Pa, kWarpsPerBlock), 32 * kWarpsPerBlock, 0, st>>>(
            in, pose_order, pose_offsets, Pa, pose_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (La > 0)
    landmark_blocks_kernel<MDIM><<<blocks_for(La, kThreads), kThreads, 0, st>>>(
        in, lm_order, lm_offsets, La, lm_out);
  return cudaGetLastError();
}

EdgeInputs edge_inputs(const void* qt, const void* xw, const void* meas,
                       const void* omega, const void* active,
                       const void* both_free, const void* m3, const void* cam,
                       long long E, int omega_stride) {
  EdgeInputs in;
  in.qt = static_cast<const double*>(qt);
  in.xw = static_cast<const double*>(xw);
  in.meas = static_cast<const double*>(meas);
  in.omega = static_cast<const double*>(omega);
  in.active = static_cast<const double*>(active);
  in.both_free = static_cast<const double*>(both_free);
  in.m3 = static_cast<const double*>(m3);
  in.cam = static_cast<const double*>(cam);
  in.E = E;
  in.omega_stride = omega_stride;
  return in;
}

}  // namespace

// Per-edge chi [E] (kernel B1).  active and m3 may be null.
extern "C" int tba_chi_edges(const void* qt, const void* xw, const void* meas,
                             const void* omega, const void* active,
                             const void* m3, const void* cam, long long E,
                             int omega_stride, int mdim, void* out,
                             void* stream) {
  if (mdim != 2 && mdim != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  const EdgeInputs in = edge_inputs(qt, xw, meas, omega, active, nullptr, m3,
                                    cam, E, omega_stride);
  auto st = static_cast<cudaStream_t>(stream);
  if (mdim == 2)
    launch_chi<2>(in, static_cast<double*>(out), st);
  else
    launch_chi<3>(in, static_cast<double*>(out), st);
  return static_cast<int>(cudaGetLastError());
}

// Hpp|bp [Pa, 42], Hll|bl [La, 12] and Hpl [E, 18] (kernel B3).  active,
// both_free and m3 may be null.
extern "C" int tba_linearise(const void* qt, const void* xw, const void* meas,
                             const void* omega, const void* active,
                             const void* both_free, const void* m3,
                             const void* cam, long long E, int omega_stride,
                             int mdim, const void* pose_order,
                             const void* pose_offsets, long long Pa,
                             const void* lm_order, const void* lm_offsets,
                             long long La, void* pose_out, void* lm_out,
                             void* hpl_out, void* stream) {
  if (mdim != 2 && mdim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const EdgeInputs in = edge_inputs(qt, xw, meas, omega, active, both_free, m3,
                                    cam, E, omega_stride);
  auto st = static_cast<cudaStream_t>(stream);
  auto po = static_cast<const int64_t*>(pose_order);
  auto pf = static_cast<const int64_t*>(pose_offsets);
  auto lo = static_cast<const int64_t*>(lm_order);
  auto lf = static_cast<const int64_t*>(lm_offsets);
  auto pose = static_cast<double*>(pose_out);
  auto lm = static_cast<double*>(lm_out);
  auto hpl = static_cast<double*>(hpl_out);
  const cudaError_t err =
      mdim == 2 ? launch_linearise<2>(in, po, pf, Pa, lo, lf, La, pose, lm, hpl, st)
                : launch_linearise<3>(in, po, pf, Pa, lo, lf, La, pose, lm, hpl, st);
  return static_cast<int>(err);
}
