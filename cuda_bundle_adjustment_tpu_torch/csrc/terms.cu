// Kernels B1 (per-edge chi) and B3 (fused linearisation) of the mono,
// stereo and depth BA models, the reference's computeActiveErrorsKernel and
// constructQuadraticFormKernel.
//
//   B1: chi[e] = omega * active * |e|^2  (rk = 0; e = proj - meas, for a
//       depth edge meas - proj)
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
// Models (the kind argument of the launchers, one instantiation each, with
// its plain twin in models/ba.py):
//   mono    MDIM 2, the mono Jacobian;
//   stereo  MDIM 3, the stereo Jacobian; a pack of mono and stereo rows
//           masks the third row of its mono rows by m3;
//   depth   MDIM 3, the residual (m0 - u, m1 - v, m2 - inv_z), meas - proj
//           as the reference has it, with the stereo Jacobian, bf row
//           included (the reference's quirk, kept);
//   mixed   MDIM 3, each edge's kind read from a byte code (0 mono, 1
//           stereo, 2 depth): the depth residual on depth rows, the stereo
//           one elsewhere, the third row masked on mono rows (code 0).
// The camera is one [5] operand for every edge, or [5, E], a camera an edge
// (cam_stride 1): a template flag, so the one-camera instantiations compile
// as they did before the per-edge camera, and the per-edge one reads 40 more
// bytes an edge in f64 (20 in f32).
//
// Arithmetic: the expressions of the plain twin (ops/components.py and
// models/ba.py) operation for operation.  The file is built with -fmad=false
// (kernels/_build.py): the residual proj - meas cancels terms as large as the
// projected pixel coordinates, and a contracted a * b + c rounds differently
// from the twin by up to an ulp of those terms.  So per-edge values (chi, the
// Hpl blocks, the per-edge stack entries) agree with the twin bit for bit and
// the per-vertex sums differ only by summation order.  The guard |z| > 1e-30
// times active gives an exact zero inv_z on inert and degenerate rows: inert
// rows (w = 0) give exact zeros everywhere, degenerate rows give zero JL and
// so zero Hll|bl and Hpl.
//
// Working type: T = double, or float in f32 mode (the solver's dtype).  Global
// memory holds T; every input is converted to double as it is read and the
// arithmetic is the f64 kernel's, in registers and in the shared-memory tiles
// (laid out in doubles either way); each output is rounded to T once, at its
// store, and the chunks' partial sums in the scratch stay double.  So the f32
// kernel's every value is the f64 kernel's on the upcast inputs, rounded once
// (kernels/_types.py: the twins do the same), the TPU kernels' f32 mode, where
// f32 inputs enter their double-float pairs as (x, 0) and the stage rounds
// hi + lo to f32.  The f64 instantiation is the kernel as it was.
//
// Bound on this card: device-memory bytes.  An edge reads its gathered pose
// state (96 B), landmark (24 B), measurement (16-24 B) and masks (8-24 B)
// and writes its Hpl block (144 B); the f64 math (~400-560 flops an edge) is
// far below the card's f64 rate.  What holds a thread-per-edge kernel far
// above that bound is the load/store unit: a warp's 8-byte access to rows 96
// or 144 bytes apart touches 24 to 36 cache lines an instruction, and a
// per-vertex pass that gathers its edges by index touches 32.
//
// Design of B3: one pass over the edges, one block a tile of kTile
// consecutive edges.
//   * The tile's [kTile, 12] pose rows and [kTile, 3] landmark rows are one
//     contiguous stretch each: the block brings them to shared memory with
//     coalesced loads, every thread then reads its own row from rows padded
//     to an odd number of doubles (no bank conflict), and the [kTile, 18] Hpl
//     tile goes back the same way, through 19-double rows.
//   * Each thread leaves its edge's per-pose stack (21 + 6 values) and
//     per-landmark stack (6 + 3) in shared memory.  A plan made once a
//     structure (kernels/terms.py make_linearise_plan) cuts every vertex's
//     run of edges, in segment order, into chunks that lie in one tile, and
//     lists each tile's chunks as rows of the tile (one byte an edge, so a
//     tile's list is one coalesced load and no index is chased).  The block
//     sums each of its chunks in that order, one thread a (chunk, entry); a
//     vertex whose run is a single chunk (nearly every landmark of a
//     landmark-sorted edge set) gets its row written at once, bit for bit
//     the twin's sequential sum; the other chunks go to a scratch row each.
//   * A second, small kernel a vertex kind sums a vertex's scratch rows in
//     chunk order (and writes zeros for a vertex without edges).
// So the edges are read once, nothing is gathered by index from device
// memory, and every sum has a fixed order that depends on the plan (the tile
// length, a constant) and not on the launch: no atomics, two runs give the
// same bits.  A vertex summed over several chunks associates as
// (chunk) + (chunk) + ..., within 1e-12 x max|value| of the twin.
// B1 stays one thread an edge.
//
// ptxas (sm_90a, nvcc 12.9, as chip_smoke.py prints it), mdim 2 / 3: the
// tile kernel 64 / 80 registers, no spill, kTile * (19 + 27 + 9) * 8 = 56320
// bytes of dynamic and 256 of static shared memory (four blocks an SM); the
// finishing kernels 20 and 25 registers; B1 32 / 40.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// B3's tile: edges a block, and the padded shared-memory rows (in doubles)
// of the pose state and of the Hpl blocks.  kernels/terms.py TILE must agree.
constexpr int kTile = 128;
constexpr int kQtRow = 13;
constexpr int kHplRow = 19;

// The models of the kind argument (kernels/terms.py _KINDS must agree) and
// the per-edge codes of a mixed pack (types.py KIND_CODES).
enum Kind : int { kMono = 0, kStereo = 1, kDepth = 2, kMixed = 3 };
constexpr uint8_t kCodeMono = 0, kCodeDepth = 2;

__host__ __device__ constexpr int mdim_of(int kind) { return kind == kMono ? 2 : 3; }

// What a per-edge evaluation reads, in the working type T.  A null mask
// reads as 1 (active, both_free) or as no mask (m3).
template <typename T>
struct EdgeInputs {
  const T* qt;         // [E, 12] per-edge pose state t | R (row-major)
  const T* xw;         // [E, 3] per-edge landmark
  const T* meas;       // [MDIM, E]
  const T* omega;      // [1] or [E]
  const T* active;     // [E] or null
  const T* both_free;  // [E] or null
  const T* m3;         // [E] or null
  const uint8_t* code;  // [E] kind codes of a mixed pack, or null
  const T* cam;        // [5] or [5, E]: fx fy cx cy bf
  int64_t E;
  int omega_stride;  // 0: one weight for every edge, 1: one per edge
};

// Entry k of edge i's camera: [5] for every edge, or [5, E] (PEC).
template <bool PEC, typename T>
__device__ __forceinline__ double cam_at(const EdgeInputs<T>& in, int64_t i, int k) {
  return static_cast<double>(PEC ? in.cam[k * in.E + i] : in.cam[k]);
}

template <int MDIM>
struct Edge {
  double R[9];
  double Xx, Xy, inv_z;
  double e[MDIM];
  double w;   // omega * active
  double m3;  // third-row mask (1 without a mask)
};

// Edge i from its pose row s [12] and landmark row X [3] (T in device
// memory, or double in shared memory) and the per-edge columns of ``in``.
template <int KIND, bool PEC, typename T, typename S>
__device__ __forceinline__ void load_edge(const EdgeInputs<T>& in, int64_t i,
                                          const S* s, const S* X,
                                          Edge<mdim_of(KIND)>& g) {
  const double fx = cam_at<PEC>(in, i, 0), fy = cam_at<PEC>(in, i, 1),
               cx = cam_at<PEC>(in, i, 2), cy = cam_at<PEC>(in, i, 3),
               bf = cam_at<PEC>(in, i, 4);
#pragma unroll
  for (int k = 0; k < 9; ++k) g.R[k] = s[3 + k];
  const double X0 = X[0], X1 = X[1], X2 = X[2];
  const double* R = g.R;
  g.Xx = R[0] * X0 + R[1] * X1 + R[2] * X2 + s[0];
  g.Xy = R[3] * X0 + R[4] * X1 + R[5] * X2 + s[1];
  const double z = R[6] * X0 + R[7] * X1 + R[8] * X2 + s[2];
  const double act = in.active ? static_cast<double>(in.active[i]) : 1.0;
  g.inv_z = act * (fabs(z) > 1e-30 ? 1.0 / z : 0.0);
  g.w = static_cast<double>(in.omega[in.omega_stride ? i : 0]) * act;
  bool depth = KIND == kDepth;
  if constexpr (KIND == kMixed) {
    const uint8_t c = in.code[i];
    g.m3 = c != kCodeMono ? 1.0 : 0.0;
    depth = c == kCodeDepth;
  } else {
    g.m3 = in.m3 ? static_cast<double>(in.m3[i]) : 1.0;
  }
  const double m0 = static_cast<double>(in.meas[i]);
  const double m1 = static_cast<double>(in.meas[in.E + i]);
  const double u = fx * g.inv_z * g.Xx + cx;
  if constexpr (KIND == kMono || KIND == kStereo) {
    g.e[0] = u - m0;
    g.e[1] = fy * g.inv_z * g.Xy + cy - m1;
  } else {
    const double v = fy * g.inv_z * g.Xy + cy;
    g.e[0] = depth ? m0 - u : u - m0;
    g.e[1] = depth ? m1 - v : v - m1;
  }
  if constexpr (KIND != kMono) {
    const double m2 = static_cast<double>(in.meas[2 * in.E + i]);
    g.e[2] = (depth ? m2 - g.inv_z : u - bf * g.inv_z - m2) * g.m3;
  }
}

// JP [MDIM][6] (ops/components.py mono_ / stereo_jacobian_comps)
template <int MDIM, bool PEC, typename T>
__device__ __forceinline__ void pose_jacobian(const EdgeInputs<T>& in, int64_t i,
                                              const Edge<MDIM>& g,
                                              double JP[MDIM][6]) {
  const double fx = cam_at<PEC>(in, i, 0), fy = cam_at<PEC>(in, i, 1);
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
    const double bf = cam_at<PEC>(in, i, 4);
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
template <int MDIM, bool PEC, typename T>
__device__ __forceinline__ void landmark_jacobian(const EdgeInputs<T>& in, int64_t i,
                                                  const Edge<MDIM>& g,
                                                  double JL[MDIM][3]) {
  const double fx = cam_at<PEC>(in, i, 0), fy = cam_at<PEC>(in, i, 1);
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
    const double bf = cam_at<PEC>(in, i, 4);
    const double inv_zz = inv_z * inv_z;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      JL[0][j] = -fx * R[j] * inv_z + fx * g.Xx * R[6 + j] * inv_zz;
      JL[1][j] = -fy * R[3 + j] * inv_z + fy * g.Xy * R[6 + j] * inv_zz;
      JL[2][j] = (JL[0][j] - bf * R[6 + j] * inv_zz) * g.m3;
    }
  }
}

template <int KIND, bool PEC, typename T>
__global__ void __launch_bounds__(kThreads)
chi_edges_kernel(EdgeInputs<T> in, T* __restrict__ out) {
  constexpr int MDIM = mdim_of(KIND);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= in.E) return;
  Edge<MDIM> g;
  load_edge<KIND, PEC>(in, i, in.qt + i * 12, in.xw + i * 3, g);
  double s = g.e[0] * g.e[0] + g.e[1] * g.e[1];
  if constexpr (MDIM == 3) s += g.e[2] * g.e[2];
  const double act = in.active ? static_cast<double>(in.active[i]) : 1.0;
  out[i] = static_cast<T>(static_cast<double>(in.omega[in.omega_stride ? i : 0]) * s * act);
}

// upper-triangle position of (a, b), a <= b, in an n x n symmetric block
__host__ __device__ constexpr int tri6(int a, int b) { return a * (11 - a) / 2 + b; }
__host__ __device__ constexpr int tri3(int a, int b) { return a * (5 - a) / 2 + b; }

// A vertex kind's share of the linearisation plan (kernels/terms.py).
template <typename T>
struct ChunkPlan {
  const uint8_t* rows;      // [n] by tile, chunk after chunk: edge id - tile's first
  const int4* chunks;       // by tile: (first, last + 1 in rows, target, 0)
  const int32_t* tile_off;  // [tiles + 1] a tile's stretch of chunks
  T* out;                   // [vertices, DIM] final rows
  double* scratch;          // [chunks, NC] partial rows, by vertex
};

// Entry q of a compressed stack row (N (N + 1) / 2 upper-triangle entries,
// then N of the vector) into the full row (N x N symmetric block, then the
// vector), rounded to the row's type.
template <int N, typename T>
__device__ __forceinline__ void write_expanded(T* row, int q, double v_) {
  const T v = static_cast<T>(v_);
  constexpr int kTri = N * (N + 1) / 2;
  if (q >= kTri) {
    row[N * N + q - kTri] = v;
    return;
  }
  int a = 0, r = q;
  while (r >= N - a) {
    r -= N - a;
    ++a;
  }
  const int b = a + r;
  row[a * N + b] = v;
  if (a != b) row[b * N + a] = v;
}

// A tile's stretch of p.rows (at most kTile entries, one a thread), read
// early so that its latency hides behind the arithmetic.
struct TileRows {
  int c0, c1;   // the tile's chunks
  int base;     // position of its first row in p.rows
  uint8_t row;  // this thread's entry
};

template <typename T>
__device__ __forceinline__ TileRows load_tile_rows(const ChunkPlan<T>& p, int tile) {
  TileRows t;
  t.c0 = p.tile_off[tile];
  t.c1 = p.tile_off[tile + 1];
  t.base = 0;
  t.row = 0;
  if (t.c1 > t.c0) {
    t.base = p.chunks[t.c0].x;
    const int n = p.chunks[t.c1 - 1].y - t.base;
    if (static_cast<int>(threadIdx.x) < n) t.row = p.rows[t.base + threadIdx.x];
  }
  return t;
}

// Sums of this tile's chunks over the stack rows the threads left in shared
// memory: one thread a (chunk, entry), the chunk's edges in segment order.
template <int N, typename T>
__device__ __forceinline__ void chunk_sums(const ChunkPlan<T>& p, const TileRows& t,
                                           const double* __restrict__ stack,
                                           const uint8_t* __restrict__ rows) {
  constexpr int NC = N * (N + 1) / 2 + N;
  const int items = (t.c1 - t.c0) * NC;
  for (int it = threadIdx.x; it < items; it += kTile) {
    const int c = it / NC, q = it - c * NC;
    const int4 ch = p.chunks[t.c0 + c];
    double acc = 0.0;
    for (int j = ch.x - t.base; j < ch.y - t.base; ++j) acc += stack[rows[j] * NC + q];
    if (ch.z < 0)
      p.scratch[static_cast<int64_t>(-1 - ch.z) * NC + q] = acc;
    else
      write_expanded<N>(p.out + static_cast<int64_t>(ch.z) * (N * N + N), q, acc);
  }
}

template <int KIND, bool PEC, typename T>
__global__ void __launch_bounds__(kTile)
edge_tile_kernel(EdgeInputs<T> in, ChunkPlan<T> pose, ChunkPlan<T> lm,
                 T* __restrict__ hpl) {
  constexpr int MDIM = mdim_of(KIND);
  extern __shared__ double smem[];
  double* s_io = smem;                      // pose|landmark rows in, Hpl out
  double* s_pose = smem + kTile * kHplRow;  // [kTile, 27]
  double* s_lm = s_pose + kTile * 27;       // [kTile, 9]
  double* s_xw = s_io + kTile * kQtRow;
  __shared__ uint8_t s_rows[2][kTile];

  const int tile = blockIdx.x, tid = threadIdx.x;
  const TileRows pose_rows = load_tile_rows(pose, tile);
  const TileRows lm_rows = load_tile_rows(lm, tile);
  const int64_t tile0 = static_cast<int64_t>(tile) * kTile;
  const int n = in.E - tile0 < kTile ? static_cast<int>(in.E - tile0) : kTile;

  // the tile's rows, coalesced: 16-byte loads of the pose rows (a row is six
  // of them in f64, three in f32, and starts on a 16-byte boundary), loads of
  // one entry for the landmarks
  if constexpr (sizeof(T) == 8) {
    const double2* qt2 = reinterpret_cast<const double2*>(in.qt + tile0 * 12);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const int c = tid + kTile * m;
      if (c < n * 6) {
        const double2 v = qt2[c];
        const int r = c / 6, k = 2 * (c - 6 * r);
        s_io[r * kQtRow + k] = v.x;
        s_io[r * kQtRow + k + 1] = v.y;
      }
    }
  } else {
    const float4* qt4 = reinterpret_cast<const float4*>(in.qt + tile0 * 12);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int c = tid + kTile * m;
      if (c < n * 3) {
        const float4 v = qt4[c];
        const int r = c / 3, k = 4 * (c - 3 * r);
        s_io[r * kQtRow + k] = v.x;
        s_io[r * kQtRow + k + 1] = v.y;
        s_io[r * kQtRow + k + 2] = v.z;
        s_io[r * kQtRow + k + 3] = v.w;
      }
    }
  }
  const T* xw = in.xw + tile0 * 3;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int c = tid + kTile * m;
    if (c < n * 3) s_xw[c] = static_cast<double>(xw[c]);
  }
  __syncthreads();

  const int64_t i = tile0 + tid;
  const bool live = tid < n;
  Edge<MDIM> g;
  if (live) load_edge<KIND, PEC>(in, i, s_io + tid * kQtRow, s_xw + tid * 3, g);
  __syncthreads();  // every row is in registers: s_io now takes the Hpl tile

  if (live) {
    double JP[MDIM][6], JL[MDIM][3];
    pose_jacobian<MDIM, PEC>(in, i, g, JP);
    landmark_jacobian<MDIM, PEC>(in, i, g, JL);
    const double wb = g.w * (in.both_free ? static_cast<double>(in.both_free[i]) : 1.0);
    double* o = s_io + tid * kHplRow;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        double s = JP[0][a] * JL[0][b];
#pragma unroll
        for (int m = 1; m < MDIM; ++m) s += JP[m][a] * JL[m][b];
        o[a * 3 + b] = s * wb;
      }
    double* sp = s_pose + tid * 27;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) {
        double s = JP[0][a] * JP[0][b];
#pragma unroll
        for (int m = 1; m < MDIM; ++m) s += JP[m][a] * JP[m][b];
        sp[tri6(a, b)] = g.w * s;
      }
      double s = JP[0][a] * g.e[0];
#pragma unroll
      for (int m = 1; m < MDIM; ++m) s += JP[m][a] * g.e[m];
      sp[21 + a] = g.w * s;
    }
    double* sl = s_lm + tid * 9;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = a; b < 3; ++b) {
        double s = JL[0][a] * JL[0][b];
#pragma unroll
        for (int m = 1; m < MDIM; ++m) s += JL[m][a] * JL[m][b];
        sl[tri3(a, b)] = g.w * s;
      }
      double s = JL[0][a] * g.e[0];
#pragma unroll
      for (int m = 1; m < MDIM; ++m) s += JL[m][a] * g.e[m];
      sl[6 + a] = g.w * s;
    }
  }
  s_rows[0][tid] = pose_rows.row;
  s_rows[1][tid] = lm_rows.row;
  __syncthreads();

  // the Hpl tile, coalesced
  T* ho = hpl + tile0 * 18;
  for (int c = tid; c < n * 18; c += kTile) {
    const int r = c / 18;
    ho[c] = static_cast<T>(s_io[r * kHplRow + (c - 18 * r)]);
  }
  chunk_sums<6>(pose, pose_rows, s_pose, s_rows[0]);
  chunk_sums<3>(lm, lm_rows, s_lm, s_rows[1]);
}

// A vertex's row from its chunks' scratch rows, in chunk order; G threads a
// vertex.  A single chunk was written by the tile kernel; none gives zeros.
template <int N, int G, typename T>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const int32_t* __restrict__ vertex_off, int64_t nv,
              const double* __restrict__ scratch, T* __restrict__ out) {
  constexpr int NC = N * (N + 1) / 2 + N;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t v = t / G;
  if (v >= nv) return;
  const int c0 = vertex_off[v], c1 = vertex_off[v + 1];
  if (c1 - c0 == 1) return;
  for (int q = static_cast<int>(t - v * G); q < NC; q += G) {
    double acc = 0.0;
#pragma unroll 4
    for (int c = c0; c < c1; ++c) acc += scratch[static_cast<int64_t>(c) * NC + q];
    write_expanded<N>(out + v * (N * N + N), q, acc);
  }
}

unsigned blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

template <int KIND, bool PEC, typename T>
void launch_chi(const EdgeInputs<T>& in, T* out, cudaStream_t st) {
  chi_edges_kernel<KIND, PEC, T><<<blocks_for(in.E, kThreads), kThreads, 0, st>>>(in, out);
}

template <int KIND, bool PEC, typename T>
cudaError_t launch_linearise(const EdgeInputs<T>& in, const ChunkPlan<T>& pose,
                             const int32_t* pose_off, int64_t Pa,
                             const ChunkPlan<T>& lm, const int32_t* lm_off,
                             int64_t La, T* hpl, cudaStream_t st) {
  if (in.E > 0) {
    // the tiles are doubles in either working type: one size
    constexpr int kBytes = kTile * (kHplRow + 27 + 9) * sizeof(double);
    static bool sized = false;  // once a process, model, camera and type
    if (!sized) {
      const cudaError_t err = cudaFuncSetAttribute(
          edge_tile_kernel<KIND, PEC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (err != cudaSuccess) return err;
      sized = true;
    }
    edge_tile_kernel<KIND, PEC, T><<<blocks_for(in.E, kTile), kTile, kBytes, st>>>(
        in, pose, lm, hpl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Pa > 0) {
    finish_kernel<6, 32><<<blocks_for(Pa * 32, kThreads), kThreads, 0, st>>>(
        pose_off, Pa, pose.scratch, pose.out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (La > 0)
    finish_kernel<3, 9><<<blocks_for(La * 9, kThreads), kThreads, 0, st>>>(
        lm_off, La, lm.scratch, lm.out);
  return cudaGetLastError();
}

// Calls f(Kind constant, camera flag constant) for the run-time kind and
// camera stride: one instantiation each.
template <typename F>
cudaError_t with_model(int kind, int cam_stride, F&& f) {
  auto cams = [&](auto k) {
    return cam_stride ? f(k, std::true_type{}) : f(k, std::false_type{});
  };
  switch (kind) {
    case kMono: return cams(std::integral_constant<int, kMono>{});
    case kStereo: return cams(std::integral_constant<int, kStereo>{});
    case kDepth: return cams(std::integral_constant<int, kDepth>{});
    case kMixed: return cams(std::integral_constant<int, kMixed>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
EdgeInputs<T> edge_inputs(const void* qt, const void* xw, const void* meas,
                          const void* omega, const void* active,
                          const void* both_free, const void* m3, const void* code,
                          const void* cam, long long E, int omega_stride) {
  EdgeInputs<T> in;
  in.qt = static_cast<const T*>(qt);
  in.xw = static_cast<const T*>(xw);
  in.meas = static_cast<const T*>(meas);
  in.omega = static_cast<const T*>(omega);
  in.active = static_cast<const T*>(active);
  in.both_free = static_cast<const T*>(both_free);
  in.m3 = static_cast<const T*>(m3);
  in.code = static_cast<const uint8_t*>(code);
  in.cam = static_cast<const T*>(cam);
  in.E = E;
  in.omega_stride = omega_stride;
  return in;
}

template <typename T>
int chi_edges(const void* qt, const void* xw, const void* meas, const void* omega,
              const void* active, const void* m3, const void* code, const void* cam,
              long long E, int omega_stride, int cam_stride, int kind, void* out,
              void* stream) {
  const EdgeInputs<T> in = edge_inputs<T>(qt, xw, meas, omega, active, nullptr, m3,
                                          code, cam, E, omega_stride);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_model(kind, cam_stride, [&](auto k, auto pec) {
    launch_chi<decltype(k)::value, decltype(pec)::value>(in, static_cast<T*>(out), st);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

template <typename T>
int linearise(const void* qt, const void* xw, const void* meas, const void* omega,
              const void* active, const void* both_free, const void* m3,
              const void* code, const void* cam, long long E, int omega_stride,
              int cam_stride, int kind, const void* pose_rows,
              const void* pose_chunks, const void* pose_tile_off,
              const void* pose_vertex_off, void* pose_scratch, long long Pa,
              const void* lm_rows, const void* lm_chunks, const void* lm_tile_off,
              const void* lm_vertex_off, void* lm_scratch, long long La,
              void* pose_out, void* lm_out, void* hpl_out, void* stream) {
  const EdgeInputs<T> in = edge_inputs<T>(qt, xw, meas, omega, active, both_free, m3,
                                          code, cam, E, omega_stride);
  auto st = static_cast<cudaStream_t>(stream);
  const ChunkPlan<T> pose = {static_cast<const uint8_t*>(pose_rows),
                             static_cast<const int4*>(pose_chunks),
                             static_cast<const int32_t*>(pose_tile_off),
                             static_cast<T*>(pose_out),
                             static_cast<double*>(pose_scratch)};
  const ChunkPlan<T> lm = {static_cast<const uint8_t*>(lm_rows),
                           static_cast<const int4*>(lm_chunks),
                           static_cast<const int32_t*>(lm_tile_off),
                           static_cast<T*>(lm_out),
                           static_cast<double*>(lm_scratch)};
  auto pf = static_cast<const int32_t*>(pose_vertex_off);
  auto lf = static_cast<const int32_t*>(lm_vertex_off);
  auto hpl = static_cast<T*>(hpl_out);
  const cudaError_t err = with_model(kind, cam_stride, [&](auto k, auto pec) {
    return launch_linearise<decltype(k)::value, decltype(pec)::value>(
        in, pose, pf, Pa, lm, lf, La, hpl, st);
  });
  return static_cast<int>(err);
}

}  // namespace

// Per-edge chi [E] (kernel B1).  active and m3 may be null; code is the
// mixed pack's [E] uint8 kinds (null for the other models).  cam is [5]
// (cam_stride 0) or [5, E] (cam_stride 1).  kind: 0 mono, 1 stereo, 2
// depth, 3 mixed.  f32: 1 where every float operand and the output are
// f32, 0 where they are f64.
extern "C" int tba_chi_edges(const void* qt, const void* xw, const void* meas,
                             const void* omega, const void* active,
                             const void* m3, const void* code, const void* cam,
                             long long E, int omega_stride, int cam_stride,
                             int kind, int f32, void* out, void* stream) {
  if (kind < kMono || kind > kMixed || (kind == kMixed) != (code != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  return f32 ? chi_edges<float>(qt, xw, meas, omega, active, m3, code, cam, E,
                                omega_stride, cam_stride, kind, out, stream)
             : chi_edges<double>(qt, xw, meas, omega, active, m3, code, cam, E,
                                 omega_stride, cam_stride, kind, out, stream);
}

// Hpp|bp [Pa, 42], Hll|bl [La, 12] and Hpl [E, 18] (kernel B3).  active,
// both_free and m3 may be null; code, cam, cam_stride and kind as for
// tba_chi_edges.  Per vertex kind the plan of kernels/terms.py
// make_linearise_plan: rows [n] (uint8), chunks [chunks, 4] and tile_off
// [tiles + 1] for the tile kernel, vertex_off [vertices + 1] for the
// finishing kernel (int32), and a scratch [chunks, 27 or 9] f64 in either
// working type.  f32: as for tba_chi_edges.
extern "C" int tba_linearise(const void* qt, const void* xw, const void* meas,
                             const void* omega, const void* active,
                             const void* both_free, const void* m3,
                             const void* code, const void* cam, long long E,
                             int omega_stride, int cam_stride, int kind, int f32,
                             const void* pose_rows, const void* pose_chunks,
                             const void* pose_tile_off, const void* pose_vertex_off,
                             void* pose_scratch, long long Pa, const void* lm_rows,
                             const void* lm_chunks, const void* lm_tile_off,
                             const void* lm_vertex_off, void* lm_scratch,
                             long long La, void* pose_out, void* lm_out,
                             void* hpl_out, void* stream) {
  if (kind < kMono || kind > kMixed || (kind == kMixed) != (code != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return f32 ? linearise<float>(qt, xw, meas, omega, active, both_free, m3, code, cam,
                                E, omega_stride, cam_stride, kind, pose_rows, pose_chunks,
                                pose_tile_off, pose_vertex_off, pose_scratch, Pa, lm_rows,
                                lm_chunks, lm_tile_off, lm_vertex_off, lm_scratch, La,
                                pose_out, lm_out, hpl_out, stream)
             : linearise<double>(qt, xw, meas, omega, active, both_free, m3, code, cam,
                                 E, omega_stride, cam_stride, kind, pose_rows, pose_chunks,
                                 pose_tile_off, pose_vertex_off, pose_scratch, Pa, lm_rows,
                                 lm_chunks, lm_tile_off, lm_vertex_off, lm_scratch, La,
                                 pose_out, lm_out, hpl_out, stream);
}
