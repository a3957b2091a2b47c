// Kernels B7 and B8: banded block Cholesky factor and solve.
//
// Storage (same contract as the JAX package): band row c*SB + d holds the
// upper 6x6 block (c, c+d) of the Jacobi-scaled reduced camera system,
// flat row-major f32, for 0 <= d < SB; the array has (Pa + SB) * SB rows.
// After the factor, row d = 0 of column c holds inv(L_cc) and rows d >= 1
// hold Lt_d = L_{(c+d),c}^T; the SB slack columns past Pa are zero.  Per
// column c (right-looking):
//   L_cc L_cc^T = A_cc;   Lt_d = inv(L_cc) U_d;
//   U'_{(c+d2),(d1-d2)} -= Lt_d2^T Lt_d1   for 1 <= d2 <= d1 < SB.
//
// Replaces: cuda_bundle_adjustment_tpu/pallas/bandchol.py band_factor2
// (pallas_call at :412, SB <= 16), band_factor (v1, :260, 16 < SB <= 48)
// and band_solve (:275).  On the TPU the whole band sits in VMEM and the
// column recurrence is a fori_loop with MXU products.  Here SB is a runtime
// value and one kernel family covers both factors.
//
// Bound on this card: neither bytes nor operations (both are microseconds)
// but the dependent chain of the column recurrence: column c + 1's pivot
// block needs column c's Lt_1, which needs column c's inverse pivot factor.
// The floor of a sequential recurrence is that chain's latency times Pa, so
// the design keeps everything else beside the chain, not in it.
//
// B7 band_factor.  One thread block.
// * A sliding window in shared memory.  The blocks that still receive
//   trailing updates never go back to device memory: block (m, e) enters
//   the window two columns before its first update and leaves when column m
//   is factored, so the blocks of one offset e form a ring of SB - e + 2
//   slots and the window is a triangle of SB (SB + 1) / 2 + 2 SB blocks (37
//   words each, so that lanes on neighbouring blocks fall on different
//   banks).  A loader warp brings each new anti-diagonal of original blocks
//   in with cp.async, a column ahead of the column that stores it into the
//   window; a finished strip is written to device memory once.
// * Accumulation.  The window is f64 for SB <= 32 and is rounded to f32
//   once, when a strip is stored (Lt_d is formed from the rounded inv(L_cc)
//   and the trailing update takes the rounded Lt_d, so the recurrence runs
//   on exactly the factor that the solve will read); over the
//   borderline reduced systems the tests keep, this is what keeps the
//   refined solve's verdicts with the reference's.  An f64 window of height
//   48 does not fit, so SB > 32 accumulates in f32.  Shared memory, all
//   dynamic: 58 KB at SB = 16, 188 KB at SB = 32 (f64), 200 KB at SB = 48.
// * Window blocks in registers.  For SB <= 22 every half block (three rows)
//   of the window belongs to one thread, which reads it from shared memory
//   at its first update, keeps it in registers and stores it once, after
//   its last: a column's update then only reads Lt from shared memory.
//   Wider bands walk the half blocks in slot order and update them in
//   shared memory.  Either way a thread's place in the update follows from
//   its slot: no index division in the loop, no idle half, no atomics.
// * A warp-parallel pivot, looked ahead.  One pivot warp owns the 6x6
//   Cholesky and the inverse of its factor: a lane per lower-triangle
//   element, exchange through a scratch block with __syncwarp() only,
//   reciprocal pivots kept and multiplied with, never a division.  It runs
//   a column ahead: of column c, column c + 1's pivot block needs only
//   Lt_1^T Lt_1, which the pivot warp forms itself, so it factors column
//   c + 1 while the other warps form and apply column c's Lt.  Where the
//   block's thread limit allows, the pivot warp has one of the SM's four
//   schedulers to itself (the other warps numbered a multiple of four idle).
// * Two barriers a column: one among the update warps between forming Lt
//   and applying it (bar.sync on a named barrier), one block-wide.
//
// B8 band_solve.  One consumer warp walks the columns; a producer warp
// streams the read-only factor ahead of it: one bulk copy (TMA) for each
// group of neighbouring columns into a ring of 8 stages (74 KB at SB = 16),
// completion on an mbarrier, with the columns' right-hand-side rows beside
// it; the consumer hands stages back through a second mbarrier.  No
// block-wide barrier in the loops.  The running right-hand side stays on
// chip: the forward sweep keeps the pending sums of the next SB blocks in
// shared memory and subtracts a block's sum from b_c once; the back
// substitution keeps the last SB solved blocks there and forms its band sum
// lane-parallel, added over the lanes in a fixed order.  x_c is written out
// once a sweep.  The solve accumulates in f32: with the factor above it
// refuses no system of that population that the reference takes, so f64
// sums have nothing left to buy there.
//
// A non-SPD pivot gives inf/NaN (rsqrt of a non-positive number), never a
// clamp: the caller's finiteness check then rejects the LM step.  No float
// atomics and fixed reduction orders: results repeat bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSB = 48;
constexpr int kF64MaxSB = 32;       // widest band whose window is f64
constexpr int kResidentMaxSB = 22;  // widest band whose window blocks live in registers
constexpr int kBlockWords = 37;     // padded stride of a 6x6 block in shared memory
constexpr int kMaxUpdateWarps = 22;
constexpr int kFactorMaxThreads = (kMaxUpdateWarps + 2) * 32;
constexpr int kSolveStages = 8;
constexpr int kSolveMaxGroup = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// B7: factor
// ---------------------------------------------------------------------------

__device__ __forceinline__ float rsqrt_acc(float x) { return rsqrtf(x); }
__device__ __forceinline__ float recip_acc(float x) { return __frcp_rn(x); }

// f64 reciprocal square root and reciprocal: the f32 unit's estimate and one
// Newton step (relative error ~1e-13, far below the f32 the factor is stored
// in).  rsqrt of a non-positive or NaN argument gives NaN.
__device__ __forceinline__ double rsqrt_acc(double x) {
  const double y = static_cast<double>(rsqrtf(static_cast<float>(x)));
  return y * (1.5 - 0.5 * x * y * y);
}
__device__ __forceinline__ double recip_acc(double x) {
  const double y = static_cast<double>(__frcp_rn(static_cast<float>(x)));
  return y * fma(-x, y, 2.0);
}

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Cholesky of a symmetric 6x6 block and the inverse of its lower factor, by
// one warp.  Lane tri(i, j) owns element (i, j), j <= i, and passes it in as
// `a`; the lanes exchange elements through the scratch arrays dm (two
// copies of the block being eliminated) and lm (the finished factor), with
// __syncwarp() only.  Only the reciprocal of the pivot and one multiply-add
// stand between one pivot and the next: every lane works the next pivot out
// for itself, so the exchange through shared memory runs beside that chain,
// and the reciprocal square root that scales the column of L is off it.  On
// return lanes 0..5 have written column `lane` of inv(L), rounded to the f32
// it is stored in, to inv_out (row-major 6x6, zeros above the diagonal).  A
// non-positive pivot gives NaN.
template <typename T>
__device__ __forceinline__ void warp_chol6_inv(T a, int i, int j, T* dm, T* lm, T* inv_out, int lane) {
  if (lane < 21) dm[i * 6 + j] = a;
  __syncwarp();
  T r[6];
  T dk = dm[0];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // step k reads one copy of the block and writes the other: everything
    // step k + 1 reads (column k + 1 and the pivot after it) is written here
    const T* cur = dm + (k & 1) * 36;
    T* nxt = dm + ((k + 1) & 1) * 36;
    const T aik = cur[max(i, k) * 6 + k];
    const T ajk = cur[max(j, k) * 6 + k];
    const T n1 = k < 5 ? cur[(k + 1) * 6 + k] : T(0);
    const T n2 = k < 5 ? cur[(k + 1) * 6 + k + 1] : T(0);
    const T rr = recip_acc(dk);
    r[k] = rsqrt_acc(dk);
    if (lane < 21) {
      if (j == k) lm[i * 6 + k] = a * r[k];
      else if (j > k) { a = a - (aik * ajk) * rr; nxt[i * 6 + j] = a; }
    }
    dk = n2 - (n1 * n1) * rr;
    __syncwarp();
  }
  // lane jj < 6 runs the forward substitution for column jj of the inverse
  if (lane < 6) {
    T inv[6];
#pragma unroll
    for (int ii = 0; ii < 6; ++ii) {
      T acc = (ii == lane) ? T(1) : T(0);
#pragma unroll
      for (int kk = 0; kk < ii; ++kk) acc -= lm[ii * 6 + kk] * inv[kk];
      inv[ii] = acc * r[ii];
    }
#pragma unroll
    for (int ii = 0; ii < 6; ++ii) inv_out[ii * 6 + lane] = static_cast<T>(static_cast<float>(inv[ii]));
  }
  __syncwarp();
}

// acc[3][6] -= (three columns of A)^T B: three rows of Lt_d2^T Lt_d1, with A
// pointing at Lt_d2's first column of the three and B at Lt_d1.
template <typename T>
__device__ __forceinline__ void subtract_half_product(T* acc, const T* A, const T* B) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    T a[3], b[6];
#pragma unroll
    for (int x = 0; x < 3; ++x) a[x] = A[k * 6 + x];
#pragma unroll
    for (int x = 0; x < 6; ++x) b[x] = B[k * 6 + x];
#pragma unroll
    for (int row = 0; row < 3; ++row)
#pragma unroll
      for (int col = 0; col < 6; ++col) acc[row * 6 + col] -= a[row] * b[col];
  }
}

__host__ __device__ inline int window_slots(int SB) { return SB * (SB + 1) / 2 + 2 * SB; }
__host__ __device__ inline int pad32(int n) { return (n + 31) / 32 * 32; }

template <typename T>
size_t factor_smem_bytes(int SB) {
  size_t n = static_cast<size_t>(SB) * 36 * sizeof(float);               // staged anti-diagonal
  n += static_cast<size_t>(window_slots(SB)) * kBlockWords * sizeof(T);  // window
  n += static_cast<size_t>(SB) * kBlockWords * sizeof(T);                // Lt
  n += 6 * 36 * sizeof(T);  // inv(L_cc) of two columns; the pivot warp's Lt_1 and scratch
  n += 3 * kMaxSB * sizeof(int);                                         // ring offsets and positions
  n += static_cast<size_t>(window_slots(SB)) + 4;                        // slot -> ring
  return n + 16;
}

// The window slot of block (m, e): ring e starts at off[e] and has
// SB - e + 2 slots; cmod[e] is c modulo that length.  A slot at position pos
// of ring e holds, at column c, the block (c + d2, e) with
// d2 = (pos - cmod[e]) mod (SB - e + 2): d2 = 0 is column c's own strip,
// 1 <= d2 <= SB - 1 - e receives this column's update, the two positions
// beyond that are being filled by the loader.
//
// RESIDENT: each half slot (three rows of a block) belongs to one thread,
// which keeps it in registers from the block's first update to its last and
// stores it to the window once; otherwise the threads walk the half slots
// and read, update and write them in shared memory every column.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(kFactorMaxThreads)
band_factor_kernel(const float* __restrict__ band, float* __restrict__ out,
                   int Pa, int SB, int update_warps, int isolate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);  // 16-byte aligned for cp.async
  T* win = reinterpret_cast<T*>(stage + SB * 36);
  T* lt = win + static_cast<size_t>(window_slots(SB)) * kBlockWords;
  T* inv_s = lt + SB * kBlockWords;  // [2][36], by column parity
  T* lt1_p = inv_s + 72;             // the pivot warp's own Lt_1
  T* dm_p = lt1_p + 36;              // and its scratch blocks
  T* lm_p = dm_p + 72;
  int* off = reinterpret_cast<int*>(lm_p + 36);
  int* cmod = off + kMaxSB;  // [2][kMaxSB], by column parity
  uint8_t* slot_ring = reinterpret_cast<uint8_t*>(cmod + 2 * kMaxSB);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nt = blockDim.x;
  const int n_update = update_warps * 32;
  // Roles.  isolate: the pivot warp is warp 0 and every other warp whose
  // number is a multiple of four idles (but for the loader, warp 4), so the
  // pivot warp has its scheduler of the SM's four to itself; the update
  // warps are the rest, in order.  Otherwise the update warps come first,
  // then the pivot warp and the loader.
  const bool is_pivot = isolate ? warp == 0 : warp == update_warps;
  const bool is_loader = isolate ? warp == 4 : warp == update_warps + 1;
  const int uwarp = isolate ? (warp / 4) * 3 + warp % 4 - 1 : warp;
  const bool is_update = (isolate ? warp % 4 != 0 : true) && uwarp < update_warps;
  const int utid = uwarp * 32 + lane;  // index among the update threads
  const int nslots = window_slots(SB);
  const int nsp = pad32(nslots);  // half 0 of every slot, then half 1: a warp never mixes them
  const int64_t last_col = static_cast<int64_t>(Pa) + SB;  // columns the band array has

  // ---- set-up, once ----
  if (tid < SB) {
    int o = 0;
    for (int e = 0; e < tid; ++e) o += SB - e + 2;
    off[tid] = o;
    cmod[tid] = 0;
    for (int pos = 0; pos < SB - tid + 2; ++pos) slot_ring[o + pos] = static_cast<uint8_t>(tid);
  }
  __syncthreads();
  // blocks whose first update comes from column 0 or 1: m + e <= SB
  for (int i = tid; i < (SB + 1) * SB * 36; i += nt) {
    const int q = i % 36, be = i / 36;
    const int e = be % SB, m = be / SB;
    if (m + e <= SB && m < last_col) {
      const int slot = off[e] + m % (SB - e + 2);
      win[slot * kBlockWords + q] = static_cast<T>(band[(static_cast<int64_t>(m) * SB + e) * 36 + q]);
    }
  }
  // the loader's first anti-diagonal in flight: blocks (SB + 1 - e, e)
  if (is_loader) {
    for (int i = lane; i < SB * 9; i += 32) {
      const int e = i / 9, part = i - e * 9;
      const int64_t m = SB + 1 - e;
      if (m < last_col) {
        const float* src = band + (m * SB + e) * 36 + part * 4;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(smem_u32(stage + e * 36 + part * 4)), "l"(src));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __syncthreads();

  // the pivot warp's lane owns element (pi, pj) of the lower triangle
  int pi = 0, pj = 0;
#pragma unroll
  for (int ii = 0; ii < 6; ++ii)
#pragma unroll
    for (int jj = 0; jj <= ii; ++jj)
      if (lane == tri(ii, jj)) { pi = ii; pj = jj; }
  if (is_pivot && Pa > 0) {
    const T* blk = win + off[0] * kBlockWords;  // block (0, 0)
    warp_chol6_inv<T>(lane < 21 ? blk[pi * 6 + pj] : T(0), pi, pj, dm_p, lm_p, inv_s, lane);
    for (int q = lane; q < 36; q += 32) out[q] = static_cast<float>(inv_s[q]);
  }
  // the resident thread's half slot: ring, position and rows
  int my_e = 0, my_pos = 0, my_r0 = 0;
  bool my_slot = false;
  if (RESIDENT && is_update && utid < 2 * nsp && utid % nsp < nslots) {
    my_slot = true;
    my_e = slot_ring[utid % nsp];
    my_pos = utid % nsp - off[my_e];
    my_r0 = (utid / nsp) * 3;
  }
  T racc[18];
#pragma unroll
  for (int q = 0; q < 18; ++q) racc[q] = T(0);
  __syncthreads();

  // ---- the column loop ----
  for (int c = 0; c < Pa; ++c) {
    const int* cm = cmod + (c & 1) * kMaxSB;
    const T* inv_c = inv_s + (c & 1) * 36;
    if (is_pivot) {
      // look-ahead: column c + 1's pivot block needs, of column c, only
      // Lt_1^T Lt_1.  Form Lt_1 here, subtract, factor and invert, beside
      // the other warps' Lt and update of column c.
      if (c + 1 < Pa) {
        T* inv_n = inv_s + ((c + 1) & 1) * 36;
        const T* next = win + (off[0] + (cm[0] + 1 == SB + 2 ? 0 : cm[0] + 1)) * kBlockWords;
        T a = lane < 21 ? next[pi * 6 + pj] : T(0);
        if (SB >= 2) {
          const T* U1 = win + (off[1] + cm[1]) * kBlockWords;
          for (int q = lane; q < 36; q += 32) {
            const int row = q / 6, col = q - row * 6;
            T v = T(0);
#pragma unroll
            for (int k = 0; k < 6; ++k) v += inv_c[row * 6 + k] * U1[k * 6 + col];
            lt1_p[q] = static_cast<T>(static_cast<float>(v));
          }
          __syncwarp();
          T u = T(0);
#pragma unroll
          for (int k = 0; k < 6; ++k) u += lt1_p[k * 6 + pi] * lt1_p[k * 6 + pj];
          a -= u;
        }
        warp_chol6_inv<T>(a, pi, pj, dm_p, lm_p, inv_n, lane);
        float* strip = out + static_cast<int64_t>(c + 1) * SB * 36;
        for (int q = lane; q < 36; q += 32) strip[q] = static_cast<float>(inv_n[q]);
      }
    } else if (is_loader) {
      // store the staged anti-diagonal (m = c + SB + 1 - e, first updated by
      // column c + 2) into the slots column c - 1 has left, then fetch the next
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      for (int i = lane; i < SB * 36; i += 32) {
        const int e = i / 36, q = i - e * 36;
        if (static_cast<int64_t>(c) + SB + 1 - e < last_col) {
          const int prev = cm[e] == 0 ? SB - e + 1 : cm[e] - 1;
          win[(off[e] + prev) * kBlockWords + q] = static_cast<T>(stage[i]);
        }
      }
      __syncwarp();
      for (int i = lane; i < SB * 9; i += 32) {
        const int e = i / 9, part = i - e * 9;
        const int64_t m = static_cast<int64_t>(c) + SB + 2 - e;
        if (m < last_col) {
          const float* src = band + (m * SB + e) * 36 + part * 4;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                       :: "r"(smem_u32(stage + e * 36 + part * 4)), "l"(src));
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      int* next = cmod + ((c + 1) & 1) * kMaxSB;
      for (int e = lane; e < SB; e += 32) next[e] = cm[e] + 1 == SB - e + 2 ? 0 : cm[e] + 1;
    } else if (is_update) {
      // A: Lt_d = inv(L_cc) U_d, half a row of a block a thread
      float* strip = out + static_cast<int64_t>(c) * SB * 36;
      for (int idx = utid; idx < (SB - 1) * 12; idx += n_update) {
        const int d = idx / 12 + 1, rh = idx - (d - 1) * 12;
        const int row = rh >> 1, c0 = (rh & 1) * 3;
        const T* U = win + (off[d] + cm[d]) * kBlockWords + c0;
        T v[3] = {T(0), T(0), T(0)};
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const T w = inv_c[row * 6 + k];
#pragma unroll
          for (int col = 0; col < 3; ++col) v[col] += w * U[k * 6 + col];
        }
#pragma unroll
        for (int col = 0; col < 3; ++col) {
          const float f = static_cast<float>(v[col]);
          strip[d * 36 + row * 6 + c0 + col] = f;
          lt[d * kBlockWords + row * 6 + c0 + col] = static_cast<T>(f);
        }
      }
      asm volatile("bar.sync 1, %0;\n" :: "r"(n_update) : "memory");
      // B: three rows of a window block a thread: block (c + d2, e) takes
      // Lt_d2^T Lt_(d2+e).  The pair d2 = 1, e = 0 is the pivot warp's.
      if (RESIDENT) {
        if (my_slot) {
          const int ring = SB - my_e + 2, last = SB - 1 - my_e;
          int d2 = my_pos - cm[my_e];
          if (d2 < 0) d2 += ring;
          if (d2 >= 1 && d2 <= last && !(my_e == 0 && d2 == 1)) {
            T* blk = win + (off[my_e] + my_pos) * kBlockWords + my_r0 * 6;
            if (d2 == last || c == 0) {
#pragma unroll
              for (int q = 0; q < 18; ++q) racc[q] = blk[q];
            }
            const T* A = lt + d2 * kBlockWords + my_r0;
            const T* B = lt + (d2 + my_e) * kBlockWords;
            subtract_half_product<T>(racc, A, B);
            if (d2 == (my_e == 0 ? 2 : 1)) {
#pragma unroll
              for (int q = 0; q < 18; ++q) blk[q] = racc[q];
            }
          }
        }
      } else {
        for (int item = utid; item < 2 * nsp; item += n_update) {
          const int sl = item < nsp ? item : item - nsp;
          if (sl >= nslots) continue;
          const int r0 = item < nsp ? 0 : 3;
          const int e = slot_ring[sl], pos = sl - off[e];
          int d2 = pos - cm[e];
          if (d2 < 0) d2 += SB - e + 2;
          if (d2 < 1 || d2 > SB - 1 - e || (e == 0 && d2 == 1)) continue;
          T* blk = win + sl * kBlockWords + r0 * 6;
          const T* A = lt + d2 * kBlockWords + r0;
          const T* B = lt + (d2 + e) * kBlockWords;
          T acc[18];
#pragma unroll
          for (int q = 0; q < 18; ++q) acc[q] = blk[q];
          subtract_half_product<T>(acc, A, B);
#pragma unroll
          for (int q = 0; q < 18; ++q) blk[q] = acc[q];
        }
      }
    }
    __syncthreads();
  }
  if (is_loader) asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the slack columns are no part of the factor
  float* slack = out + static_cast<int64_t>(Pa) * SB * 36;
  for (int i = tid; i < SB * SB * 36; i += nt) slack[i] = 0.0f;
}

// ---------------------------------------------------------------------------
// B8: solve
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void pair_barrier() {  // the two warps of the solve
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
}

// A stage holds a group of G neighbouring columns: their G whole strips (one
// contiguous piece of the factor), then 8 floats a column of which the first
// six are its right-hand-side row.
__host__ __device__ inline int solve_group(int SB) {
  const int g = 64 / SB;
  return g < 1 ? 1 : (g > kSolveMaxGroup ? kSolveMaxGroup : g);
}
__host__ __device__ inline int solve_stage_floats(int SB, int G) { return G * (SB * 36 + 8); }
// carry [SB][8], a spare row for lanes with nothing to push, and the
// consumer's exchange buffers
__host__ __device__ inline int solve_carry_floats(int SB) { return SB * 8 + 32 + 48; }

size_t solve_smem_bytes(int SB) {
  return 2 * kSolveStages * sizeof(uint64_t)
       + static_cast<size_t>(kSolveStages) * solve_stage_floats(SB, solve_group(SB)) * sizeof(float)
       + static_cast<size_t>(solve_carry_floats(SB)) * sizeof(float) + 16;
}

// The producer's rows of one group (at most 16 columns of 6 floats), three a lane.
struct GroupRows { float v[3]; };

__device__ __forceinline__ GroupRows load_rows(const float* src, int c0, int ncols, int lane) {
  GroupRows r;
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int idx = lane + 32 * u;
    r.v[u] = idx < ncols * 6 ? src[static_cast<int64_t>(c0) * 6 + idx] : 0.0f;
  }
  return r;
}

// BW: the widest band this instantiation unrolls for.
template <int BW>
__global__ void __launch_bounds__(64)
band_solve_kernel(const float* __restrict__ L, const float* __restrict__ b,
                  float* x, int Pa, int SB, int bw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kSolveStages;
  float* ring = reinterpret_cast<float*>(empty + kSolveStages);
  const int G = solve_group(SB);
  const int stage_floats = solve_stage_floats(SB, G);
  float* carry = ring + kSolveStages * stage_floats;  // [SB][8]: pending sums, then solved blocks
  float* spare = carry + SB * 8;                      // [32]
  float* vbuf = spare + 32;                           // [8]: y_c or z, for every lane to read
  float* pbuf = vbuf + 8;                             // [32]: the back substitution's partial sums
  const int ngroups = (Pa + G - 1) / G;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kSolveStages; ++s) {
      mbar_init(full + s, 2);   // the copy's expect_tx arrival and the rows'
      mbar_init(empty + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < solve_carry_floats(SB); i += 64) carry[i] = 0.0f;
  __syncthreads();

  if (warp == 1) {
    // ---- producer: groups 0 .. ngroups-1 with b's rows, then back with y's ----
    GroupRows cur = load_rows(b, 0, min(G, Pa), lane);
    for (int it = 0; it < 2 * ngroups; ++it) {
      const int g = it < ngroups ? it : 2 * ngroups - 1 - it;
      const int c0 = g * G, ncols = min(G, Pa - c0);
      if (it == ngroups) {
        pair_barrier();  // the consumer has written every y_c
        cur = load_rows(x, c0, ncols, lane);
      }
      // the next group's rows travel while this group's stage is filled
      GroupRows nxt = cur;
      if (it + 1 < 2 * ngroups && it + 1 != ngroups) {
        const int gn = it + 1 < ngroups ? it + 1 : 2 * ngroups - 2 - it;
        nxt = load_rows(it + 1 < ngroups ? b : x, gn * G, min(G, Pa - gn * G), lane);
      }
      const int s = it % kSolveStages;
      float* st = ring + s * stage_floats;
      mbar_wait(empty + s, ((static_cast<uint32_t>(it / kSolveStages)) & 1u) ^ 1u);
      if (lane == 0) {
        const uint32_t bytes = static_cast<uint32_t>(ncols * SB * 36 * sizeof(float));
        mbar_arrive_expect_tx(full + s, bytes);
        bulk_copy_g2s(st, L + static_cast<int64_t>(c0) * SB * 36, bytes, full + s);
      }
      float* rows = st + G * SB * 36;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int idx = lane + 32 * u;
        if (idx < ncols * 6) rows[(idx / 6) * 8 + idx % 6] = cur.v[u];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full + s);
      cur = nxt;
    }
    return;
  }

  // ---- consumer ----
  // The lanes hand 6-vectors to each other through shared memory and
  // __syncwarp(): on this card one such round trip costs less than the six
  // shuffles a broadcast would take.
  constexpr int kPushRounds = (BW * 6 + 31) / 32;  // forward: lane t, t + 32, ... over (d, j)
  constexpr int kSumRounds = (BW + 4) / 5;         // backward: offsets d_lane + 1, + 6, ...
  const int i6 = lane % 6;       // the row or column of a 6-vector this lane forms
  const int d_lane = lane / 6;   // its first band offset, less one
  int slot = 0;                  // c modulo SB
  // forward: y_c = inv(L_cc) (b_c - pending_c);  pending_{c+d} += Lt_d^T y_c
  for (int it = 0; it < ngroups; ++it) {
    const int s = it % kSolveStages;
    const float* stg = ring + s * stage_floats;
    const int c0 = it * G, ncols = min(G, Pa - c0);
    mbar_wait(full + s, static_cast<uint32_t>(it / kSolveStages) & 1u);
    for (int ci = 0; ci < ncols; ++ci) {
      const int c = c0 + ci;
      const float* st = stg + ci * SB * 36;
      const float* row = stg + G * SB * 36 + ci * 8;
      float* pend = carry + slot * 8;
      float yi = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) yi += st[i6 * 6 + k] * (row[k] - pend[k]);
      if (lane < 6) vbuf[lane] = yi;
      __syncwarp();  // y_c is out, and every lane has read pending_c
      if (lane < 6) {
        x[static_cast<int64_t>(c) * 6 + lane] = yi;
        pend[lane] = 0.0f;  // the slot now belongs to block c + SB
      }
      float y[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) y[a] = vbuf[a];
      const int nd6 = min(bw, Pa - 1 - c) * 6;
#pragma unroll
      for (int u = 0; u < kPushRounds; ++u) {
        // a lane with nothing to push runs the same code on the spare row
        const int t = lane + 32 * u;
        const bool valid = t < nd6;
        const int tt = valid ? t : 0;
        const int d = tt / 6 + 1, j = tt - (d - 1) * 6;
        float acc = 0.0f;
#pragma unroll
        for (int a = 0; a < 6; ++a) acc += st[d * 36 + a * 6 + j] * y[a];
        const int sd = slot + d < SB ? slot + d : slot + d - SB;
        float* tg = valid ? carry + sd * 8 + j : spare + lane;
        *tg += acc;
      }
      __syncwarp();
      slot = slot + 1 == SB ? 0 : slot + 1;
    }
    if (lane == 0) mbar_arrive(empty + s);
  }
  pair_barrier();
  // backward: z = y_c - sum_d Lt_d x_{c+d};  x_c = inv(L_cc)^T z
  slot = (Pa - 1) % SB;
  for (int it = ngroups; it < 2 * ngroups; ++it) {
    const int s = it % kSolveStages;
    const float* stg = ring + s * stage_floats;
    const int c0 = (2 * ngroups - 1 - it) * G, ncols = min(G, Pa - c0);
    mbar_wait(full + s, static_cast<uint32_t>(it / kSolveStages) & 1u);
    for (int ci = ncols - 1; ci >= 0; --ci) {
      const int c = c0 + ci;
      const float* st = stg + ci * SB * 36;
      const float* row = stg + G * SB * 36 + ci * 8;
      const int nd = min(bw, Pa - 1 - c);
      // lane (d_lane, i6) sums its band offsets d_lane + 1, d_lane + 6, ...
      // (five offsets a round; lanes 30 and 31 add nothing); then lanes
      // 0..5 add the five partial sums of their row in a fixed order
      float part = 0.0f;
#pragma unroll
      for (int u = 0; u < kSumRounds; ++u) {
        const int d = d_lane + 1 + 5 * u;
        const bool valid = d <= nd && lane < 30;
        const int dd = valid ? d : 0;
        const float* xd = carry + (slot + dd < SB ? slot + dd : slot + dd - SB) * 8;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) acc += st[dd * 36 + i6 * 6 + j] * xd[j];
        part += valid ? acc : 0.0f;
      }
      pbuf[lane] = part;
      __syncwarp();
      if (lane < 6)
        vbuf[lane] = row[lane] - ((((pbuf[lane] + pbuf[lane + 6]) + pbuf[lane + 12]) + pbuf[lane + 18]) + pbuf[lane + 24]);
      __syncwarp();
      float xi = 0.0f;
#pragma unroll
      for (int a = 0; a < 6; ++a) xi += st[a * 6 + i6] * vbuf[a];
      if (lane < 6) {
        x[static_cast<int64_t>(c) * 6 + lane] = xi;
        carry[slot * 8 + lane] = xi;
      }
      __syncwarp();
      slot = slot == 0 ? SB - 1 : slot - 1;
    }
    if (lane == 0) mbar_arrive(empty + s);
  }
}

template <typename T, bool RESIDENT>
int launch_factor(const float* band, float* out, int Pa, int SB, cudaStream_t stream) {
  const int items = 2 * pad32(window_slots(SB));  // half slots
  int warps = items / 32;
  if (!RESIDENT && warps > kMaxUpdateWarps) warps = kMaxUpdateWarps;
  if (warps > kMaxUpdateWarps) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = factor_smem_bytes<T>(SB);
  cudaError_t err = cudaFuncSetAttribute(band_factor_kernel<T, RESIDENT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // isolate the pivot warp where the block stays within its thread limit
  const int groups = (warps + 2) / 3 < 2 ? 2 : (warps + 2) / 3;
  const int isolate = 4 * groups * 32 <= kFactorMaxThreads;
  const int threads = isolate ? 4 * groups * 32 : (warps + 2) * 32;
  band_factor_kernel<T, RESIDENT><<<1, threads, smem, stream>>>(band, out, Pa, SB, warps, isolate);
  return static_cast<int>(cudaGetLastError());
}

template <int BW>
int launch_solve(const float* L, const float* b, float* x, int Pa, int SB, int bw,
                 cudaStream_t stream) {
  const size_t smem = solve_smem_bytes(SB);
  cudaError_t err = cudaFuncSetAttribute(band_solve_kernel<BW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_solve_kernel<BW><<<1, 64, smem, stream>>>(L, b, x, Pa, SB, bw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tba_band_factor(const void* band, void* out, int Pa, int SB,
                               void* stream) {
  if (SB < 1 || SB > kMaxSB || Pa < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* in = static_cast<const float*>(band);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (SB <= kResidentMaxSB) return launch_factor<double, true>(in, o, Pa, SB, st);
  if (SB <= kF64MaxSB) return launch_factor<double, false>(in, o, Pa, SB, st);
  return launch_factor<float, false>(in, o, Pa, SB, st);
}

extern "C" int tba_band_solve(const void* L, const void* b, void* x, int Pa,
                              int SB, int bw, void* stream) {
  if (SB < 1 || SB > kMaxSB || bw < 0 || bw >= SB || Pa < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Pa == 0) return 0;
  const float* Lf = static_cast<const float*>(L);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw <= 15) return launch_solve<15>(Lf, bf, xf, Pa, SB, bw, st);
  if (bw <= 31) return launch_solve<31>(Lf, bf, xf, Pa, SB, bw, st);
  return launch_solve<47>(Lf, bf, xf, Pa, SB, bw, st);
}

