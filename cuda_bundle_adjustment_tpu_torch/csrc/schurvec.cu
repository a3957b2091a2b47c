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
// would differ by an ulp of the terms.
//
// Working type: T = double, or float in f32 mode, for Hpl, the vectors, the
// right-hand side and the output; the products and sums are double in either
// (the tile's raw Hpl rows sit in shared memory as T and are converted as
// they are read; the products, partials and scratch are double), and each
// output is rounded to T once, at its store (kernels/_types.py: the twins do
// the same).  The f64 instantiation is the kernel as it was.
//
// Bound on this card: device-memory bytes.  Each edge reads its Hpl block
// (144 B) and the index of its other vertex (8 B), and gathers a row of y or
// xp (24 or 48 B, L2-resident); 6 or 3 outputs a vertex.  At KITTI-00 scale
// that is ~90 MB a call, against 2 x 18 f64 multiply-adds an edge.  What
// held the kernels before (a warp a pose, a thread a landmark, each edge
// found through the segment plan's order[] and fetched by its own thread)
// was the load/store unit: a warp's 8-byte loads of rows 144 bytes apart
// touch 32 cache lines an instruction, behind a chain of two dependent
// index loads an edge.
//
// Design: one pass over tiles of kTile consecutive edges, a block a tile,
// over B3's plan (kernels/terms.py make_linearise_plan: every vertex's run
// of edges, in segment order, cut into chunks that lie in one tile).
//   * The tile's Hpl rows come to shared memory by 16-byte asynchronous
//     copies (cp.async, no registers held), coalesced, and its slice of the
//     index array with 8-byte loads; each thread gathers its edge's vector
//     row and leaves the edge's product in shared memory, in the place of
//     the tile's rows.  Nothing walks order[].
//   * The block then sums each of the tile's chunks in segment order, one
//     thread a (chunk, entry).  A vertex of one chunk gets its row, base -
//     sum, at once: bit for bit the twin's sequential sum.
//   * A vertex of several chunks is finished in the same launch by the
//     block that completes its last chunk: every block adds one to the
//     vertex's int32 counter for each of its chunks once the chunk's partial
//     is in device memory (__threadfence), and the block that brings the
//     counter to the vertex's number of chunks sums the partials in the
//     plan's order, writes the row and sets the counter back to 0.  B5's
//     partials are chunk sums, added in chunk order: the twin's terms
//     associated as (chunk) + (chunk) + ..., within 1e-12 x max|value| of it
//     and bit for bit the sum in the plan's order.  B9's partials are the
//     edges' products in segment order, added one by one: bit for bit the
//     twin's sum at every input.
//   * Vertices without an edge get base - 0, spread over the grid.
// Integer atomics only, and the order of every float sum is fixed by the
// plan whichever block comes last: two runs give the same bits, and a call
// is one launch.  The counters are zero between launches, so two launches
// with one plan must not run at the same time (one stream).
//
// ptxas (sm_90a, nvcc 12.9, as chip_smoke.py prints it): 46 (B5) and 48
// (B9) registers, no spill, 21120 bytes of static shared memory: ten blocks
// an SM.  What holds it (tools/schurvec_clock.py --ablate): streaming the
// tiles alone takes ~0.028 ms at KITTI-00 scale, the bound; the chunk sums
// and the counters lengthen each block's life after its loads, and with ten
// blocks an SM fewer tiles are in flight.  Two tiles a resident block, the
// next one's copies in flight while the current one is summed, needed 83-96
// registers and five blocks an SM, and was slower.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// edges a block (kernels/terms.py TILE must agree)
constexpr int kTile = 128;

// A vertex kind's share of the plan (kernels/terms.py ChunkPlan), the
// kernel's per-vertex counters and scratch.
struct ChunkPlan {
  const uint8_t* rows;        // [n] by tile, chunk after chunk: edge id - tile's first
  const int4* chunks;         // by tile: first, last + 1 (in rows), target, vertex
  const int32_t* tile_off;    // [tiles + 1] a tile's stretch of chunks
  const int32_t* vertex_off;  // [vertices + 1] a vertex's stretch of chunk numbers
  const int32_t* slot;        // B9: [chunks + 1] first scratch slot by chunk number
  int32_t* count;             // [vertices] zero between launches
  double* scratch;            // B5: [chunks, 6] by number; B9: [slots, 3]
};

// N = 6: B5 (per pose, y rows of 3); N = 3: B9 (per landmark, xp rows of 6)
template <int N, typename T>
struct Args {
  const T* hpl;        // [E, 18]
  const T* vec;        // [nvec, 9 - N]
  const int64_t* idx;  // [E] the other vertex of each edge
  const T* base;       // [V, N], rows ldb apart
  int64_t ldb;
  T* out;              // [V, N]
  ChunkPlan p;
  int64_t E, V, nvec;
  int ntiles;
};

// the edge's product: Hpl . y (N = 6) or Hpl^T . xp (N = 3), in the twin's
// order (flat_mv_6x3, flat_mtv_6x3)
// (h in the working type: an f32 entry is promoted to double exactly)
template <int N, typename T>
__device__ __forceinline__ void edge_product(const T* h, const double* v, double* r) {
  if constexpr (N == 6) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
      r[i] = static_cast<double>(h[i * 3]) * v[0] + static_cast<double>(h[i * 3 + 1]) * v[1] +
             static_cast<double>(h[i * 3 + 2]) * v[2];
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      double s = static_cast<double>(h[k]) * v[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) s += static_cast<double>(h[c * 3 + k]) * v[c];
      r[k] = s;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// One tile of edges: the products, the tile's chunk sums and the vertices
// whose last chunk this block sums.
template <int N, typename T>
__device__ __forceinline__ void tile_pass(const Args<N, T>& a) {
  constexpr int K = 9 - N;              // width of the gathered vector row
  constexpr int kRow = N == 6 ? 7 : 3;  // odd row of the products: no bank conflict
  // the tile's Hpl rows as they lie in device memory (T), then the products
  // (double)
  __shared__ __align__(16) double s_tile[kTile * 18];
  __shared__ int4 s_chunks[kTile];
  __shared__ uint8_t s_rows[kTile];
  __shared__ int s_finish[kTile];  // by chunk: the vertex this block finishes, or -1

  const int tid = threadIdx.x, tile = blockIdx.x;
  const int64_t tile0 = static_cast<int64_t>(tile) * kTile;
  const int n = a.E - tile0 < kTile ? static_cast<int>(a.E - tile0) : kTile;
  const bool live = tid < n;

  // the tile's Hpl rows: 16-byte asynchronous copies (nine a thread in f64,
  // four or five in f32), straight to shared memory; an f32 tile of an odd
  // number of edges ends in 8 bytes, copied by one thread; meanwhile the
  // chunk list, the rows, the other vertex's index and its vector row
  const int c0 = a.p.tile_off[tile], c1 = a.p.tile_off[tile + 1];
  const char* src = reinterpret_cast<const char*>(a.hpl + tile0 * 18);
  char* dst = reinterpret_cast<char*>(s_tile);
  constexpr int kCopies = kTile * 18 * static_cast<int>(sizeof(T)) / 16;  // a full tile
  const int bytes = n * 18 * static_cast<int>(sizeof(T));
#pragma unroll
  for (int m = 0; m < (kCopies + kTile - 1) / kTile; ++m) {
    const int c = tid + kTile * m;
    if (16 * c + 16 <= bytes)
      cp_async16(dst + 16 * c, src + 16 * c);
    else if (16 * c < bytes)
      *reinterpret_cast<uint2*>(dst + 16 * c) = *reinterpret_cast<const uint2*>(src + 16 * c);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  int64_t other = live ? a.idx[tile0 + tid] : 0;
  const int nch = c1 - c0;
  if (nch == 0) {  // no edge of the tile has a free vertex of this kind
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  if (tid < nch) s_chunks[tid] = a.p.chunks[c0 + tid];
  const int base_row = a.p.chunks[c0].x;
  const int nrows = a.p.chunks[c1 - 1].y - base_row;
  if (tid < nrows) s_rows[tid] = a.p.rows[base_row + tid];
  other = other < 0 ? 0 : (other < a.nvec ? other : a.nvec - 1);
  double vec[K];
  if (live) {
    const T* vr = a.vec + other * K;
#pragma unroll
    for (int k = 0; k < K; ++k) vec[k] = vr[k];
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  double r[N];
  if (live) edge_product<N>(reinterpret_cast<const T*>(s_tile) + tid * 18, vec, r);
  __syncthreads();  // every row is read: the products take the tile's place
  double* s_prod = s_tile;
  if (live) {
#pragma unroll
    for (int q = 0; q < N; ++q) s_prod[tid * kRow + q] = r[q];
  }
  __syncthreads();

  // the tile's chunks in segment order, a thread a (chunk, entry)
  bool shared_chunk = false;
  for (int it = tid; it < nch * N; it += kTile) {
    const int c = it / N, q = it - c * N;
    const int4 ch = s_chunks[c];
    const int j0 = ch.x - base_row, j1 = ch.y - base_row;
    if (ch.z >= 0) {
      double acc = 0.0;
      for (int j = j0; j < j1; ++j) acc += s_prod[s_rows[j] * kRow + q];
      const int64_t v = ch.z;
      a.out[v * N + q] = static_cast<T>(static_cast<double>(a.base[v * a.ldb + q]) - acc);
    } else if constexpr (N == 6) {
      double acc = 0.0;
      for (int j = j0; j < j1; ++j) acc += s_prod[s_rows[j] * kRow + q];
      a.p.scratch[static_cast<int64_t>(-1 - ch.z) * N + q] = acc;
      shared_chunk = true;
    } else {
      double* slot = a.p.scratch + static_cast<int64_t>(a.p.slot[-1 - ch.z]) * N + q;
      for (int j = j0; j < j1; ++j) slot[(j - j0) * N] = s_prod[s_rows[j] * kRow + q];
      shared_chunk = true;
    }
  }
  // the counters, once every partial of the tile is in device memory
  if (!__syncthreads_or(shared_chunk)) return;
  __threadfence();
  __syncthreads();
  if (tid < nch) {
    const int4 ch = s_chunks[tid];
    int finish = -1;
    if (ch.z < 0) {
      const int total = a.p.vertex_off[ch.w + 1] - a.p.vertex_off[ch.w];
      if (atomicAdd(a.p.count + ch.w, 1) == total - 1) {
        a.p.count[ch.w] = 0;  // no other block touches it in this launch
        finish = ch.w;
      }
    }
    s_finish[tid] = finish;
  }
  if (!__syncthreads_or(tid < nch && s_finish[tid] >= 0)) return;
  __threadfence();

  // the vertices this block finishes: their partials in the plan's order,
  // read past L1 (other blocks wrote them), eight loads in flight
  for (int it = tid; it < nch * N; it += kTile) {
    const int c = it / N, q = it - c * N;
    const int v = s_finish[c];
    if (v < 0) continue;
    int k0, k1;
    if constexpr (N == 6) {
      k0 = a.p.vertex_off[v];
      k1 = a.p.vertex_off[v + 1];
    } else {
      k0 = a.p.slot[a.p.vertex_off[v]];
      k1 = a.p.slot[a.p.vertex_off[v + 1]];
    }
    const double* part_of = a.p.scratch + q;
    double acc = 0.0;
    for (int k = k0; k < k1; k += 8) {
      double part[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        part[u] = k + u < k1 ? __ldcg(part_of + static_cast<int64_t>(k + u) * N) : 0.0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k + u < k1) acc += part[u];
    }
    a.out[static_cast<int64_t>(v) * N + q] =
        static_cast<T>(static_cast<double>(a.base[v * a.ldb + q]) - acc);
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(kTile)
schur_vector_kernel(Args<N, T> a) {
  if (static_cast<int>(blockIdx.x) < a.ntiles) tile_pass<N>(a);
  // vertices without an edge: base - 0, a thread a vertex over the grid
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x; v < a.V;
       v += static_cast<int64_t>(gridDim.x) * kTile) {
    if (a.p.vertex_off[v + 1] != a.p.vertex_off[v]) continue;
#pragma unroll
    for (int q = 0; q < N; ++q)
      a.out[v * N + q] = static_cast<T>(static_cast<double>(a.base[v * a.ldb + q]) - 0.0);
  }
}

template <int N, typename T>
int launch(const void* hpl, const void* vec, const void* idx, const void* base,
           long long ldb, const void* rows, const void* chunks, const void* tile_off,
           const void* vertex_off, const void* slot, void* count, void* scratch,
           long long E, long long V, long long nvec, void* out, void* stream) {
  if (V == 0) return 0;
  Args<N, T> a;
  a.hpl = static_cast<const T*>(hpl);
  a.vec = static_cast<const T*>(vec);
  a.idx = static_cast<const int64_t*>(idx);
  a.base = static_cast<const T*>(base);
  a.ldb = ldb;
  a.out = static_cast<T*>(out);
  a.p = {static_cast<const uint8_t*>(rows), static_cast<const int4*>(chunks),
         static_cast<const int32_t*>(tile_off), static_cast<const int32_t*>(vertex_off),
         static_cast<const int32_t*>(slot), static_cast<int32_t*>(count),
         static_cast<double*>(scratch)};
  a.E = E;
  a.V = V;
  a.nvec = nvec;
  a.ntiles = static_cast<int>((E + kTile - 1) / kTile);
  const long long for_vertices = (V + kTile - 1) / kTile;
  const long long blocks = a.ntiles > for_vertices ? a.ntiles : for_vertices;
  schur_vector_kernel<N, T><<<static_cast<unsigned>(blocks), kTile, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bsc [Pa, 6] (kernel B5) from bp [Pa, 6] with rows ldb apart, over the
// plan's pose half (kernels/terms.py): rows, chunks, tile_off, vertex_off;
// counters [Pa] and scratch [pose chunks, 6] (f64).  f32: 1 where Hpl, y, bp
// and bsc are f32, 0 for f64.
extern "C" int tba_hpl_mv_segment_sum(const void* hpl, const void* y,
                                      const void* lm_idx, const void* bp,
                                      long long ldb, const void* rows, const void* chunks,
                                      const void* tile_off, const void* vertex_off,
                                      void* count, void* scratch, long long E,
                                      long long Pa, long long La, int f32, void* out,
                                      void* stream) {
  return f32 ? launch<6, float>(hpl, y, lm_idx, bp, ldb, rows, chunks, tile_off, vertex_off,
                                nullptr, count, scratch, E, Pa, La, out, stream)
             : launch<6, double>(hpl, y, lm_idx, bp, ldb, rows, chunks, tile_off, vertex_off,
                                 nullptr, count, scratch, E, Pa, La, out, stream);
}

// cl [La, 3] (kernel B9) from bl [La, 3] with rows ldb apart, over the
// plan's landmark half, its slots [lm chunks + 1], counters [La] and
// scratch [slots, 3] (f64).  f32 as above.
extern "C" int tba_hpl_mtv_segment_sum(const void* hpl, const void* xp,
                                       const void* pose_idx, const void* bl,
                                       long long ldb, const void* rows, const void* chunks,
                                       const void* tile_off, const void* vertex_off,
                                       const void* slot, void* count, void* scratch,
                                       long long E, long long La, long long Pa, int f32,
                                       void* out, void* stream) {
  return f32 ? launch<3, float>(hpl, xp, pose_idx, bl, ldb, rows, chunks, tile_off,
                                vertex_off, slot, count, scratch, E, La, Pa, out, stream)
             : launch<3, double>(hpl, xp, pose_idx, bl, ldb, rows, chunks, tile_off,
                                 vertex_off, slot, count, scratch, E, La, Pa, out, stream);
}
