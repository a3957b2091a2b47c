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
// Working type: T = double, or float in f32 mode, for Hpl, the inverses and
// the blocks.  The stages hold the rows as they lie in device memory (T, the
// same row strides in entries, so an f32 stage is half the bytes); each lane
// converts what it reads to double, and the products, the lanes' sums and
// the items' scratch rows are double in either type; a block's row is
// rounded to T once, at its store (kernels/_types.py: the twin does the
// same).  The f64 instantiation is the kernel as it was.
//
// Bound on this card: bytes, by the count of inputs read once (the triples'
// indices, Hpl, the inverses) and the blocks written.  What the kernel really
// moves is the gathered rows: a triple reads two 144-byte Hpl rows and a
// 72-byte inverse through the caches, 1.7 M triples at KITTI-00 scale.  A
// lane that fetches its own rows with 8-byte loads makes the load/store unit
// touch 32 cache lines an instruction, 45 instructions a triple: that, not
// the arithmetic (324 f64 operations a triple) or the registers, held the
// first version (a warp a block, a lane a triple) at 0.29 ms a call.
//
// Design: a plan made once a structure (kernels/pairprod.py make_pair_plan)
// holds the triples as int32 (ei, ej and the landmark of ei, so no index is
// chased through lm_idx) and cuts every block's run of triples into items of
// at most 128.  One warp takes an item, kStep = 16 triples a step, two lanes
// a triple (each sums three rows of the 6x6 product: 18 sums a lane, not 36):
//   * the warp copies the step's 16 + 16 + 16 rows to shared memory together
//     (cp.async, 16 bytes a lane for Hpl, 8 for the inverses: neighbouring
//     lanes on neighbouring addresses, so an instruction touches 4 rows, not
//     32); where every triple of the step has ei == ej (diagonal blocks) the
//     second copy is left out;
//   * the steps are pipelined: while step n is multiplied, the rows of step
//     n + 1 are being copied into a second stage and the indices of step
//     n + 2 loaded, across the warp's items;
//   * each lane reads its triple's rows from shared memory (Hpl rows padded
//     to 22 doubles: no bank conflict), forms its rows of W and adds
//     W Hpl[ej]^T to its sums;
//   * at an item's end a fixed shuffle tree sums the lanes; a block that is
//     one item gets its row written at once, else the item's sums go to a
//     scratch row and a second small kernel adds a block's scratch rows in
//     item order (and writes zeros for a block without triples).
// The grid is as many thread blocks as the card holds at a time; warp w of
// them all takes items w, w + warps, ...: long and short items even out
// over a warp's share, and neighbouring items, which read the same edges'
// rows, run at the same time.  No atomics: the order of every sum is fixed
// by the plan, and a second launch gives the same bits.
//
// ptxas (sm_90a, nvcc 12.9, as chip_smoke.py prints it): the item kernel 134
// registers, no spill, 54272 bytes of dynamic shared memory (4 warps x 2
// stages x 848 doubles), three thread blocks an SM; the finishing kernel 28
// registers.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;         // warps a thread block
constexpr int kMinBlocks = 3;     // thread blocks an SM is to hold (caps the registers)
constexpr int kSplit = 2;         // lanes a triple: each forms 6 / kSplit rows of the product
constexpr int kStep = 32 / kSplit;  // triples a warp takes in one step
constexpr int kRows = 6 / kSplit;   // rows of the 6x6 product a lane sums
// Shared-memory row of an Hpl block, in entries: aligned for the copies
// (16 bytes in f64, 8 in f32), and 22 keeps the reads of a half warp (its
// kStep / 2 rows, two lanes a row 9 entries apart where kSplit is 2) on
// different banks, in either type.
constexpr int kHplRow = 22;
// entries of one stage: the step's Hpl[ei] rows, Hpl[ej] rows and inverses
// (a multiple of 8 bytes in either type: the lanes' sums pass through it as
// doubles)
constexpr int kStage = 2 * kStep * kHplRow + kStep * 9;
constexpr unsigned kFull = 0xffffffffu;

// V entries of type T (4, 8 or 16 bytes) from device to shared memory,
// asynchronously.
template <int V, typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
                 : "memory");
  else if constexpr (kBytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
                 : "memory");
}

// Rows src[idx of triple r] (W entries each) of the step's kStep triples
// into dst[r * S ..], the 32 lanes striding over the rows' pieces of V
// entries.  Triple r's index is held by lane r * kSplit.
template <int W, int S, int V, typename T>
__device__ __forceinline__ void stage_rows(T* dst,
                                           const T* __restrict__ src,
                                           int idx, int lane) {
  constexpr int kPieces = W / V;  // a row
  constexpr int kAll = kStep * kPieces;
  static_assert(W % V == 0 && S % V == 0, "pieces must stay aligned");
#pragma unroll
  for (int m = 0; m < (kAll + 31) / 32; ++m) {
    const int c = lane + 32 * m;
    const int r = min(c / kPieces, kStep - 1), k = (c - r * kPieces) * V;
    const int row = __shfl_sync(kFull, idx, r * kSplit);
    if (kAll % 32 == 0 || c < kAll)
      cp_async<V>(dst + r * S + k, src + static_cast<int64_t>(row) * W + k);
  }
}

// The warp's place in its list of steps: its next item (a warp takes items
// first, first + stride, ...) and the next step's first triple.
struct Cursor {
  int it, stride, t0, end, target;
  bool valid;
};

// One step: kStep triples of one item.
struct Step {
  int ei, ej, lm;  // of the lane's triple
  int n;           // live triples of the step
  int target;      // the item's
  bool same;       // every triple has ei == ej: Hpl[ej] is Hpl[ei] (set when the rows are copied,
                   // so that nothing waits for the indices before then)
  bool last;       // the item ends with this step
  bool valid;
};

__device__ __forceinline__ void open_item(Cursor& c, const int4* __restrict__ items,
                                          int nitems) {
  c.valid = c.it < nitems;
  if (c.valid) {
    const int4 item = items[c.it];  // first triple, last + 1, target
    c.t0 = item.x;
    c.end = item.y;
    c.target = item.z;
  }
}

// The indices of the cursor's step, and the cursor moved on.  Uniform per warp.
__device__ __forceinline__ Step next_step(Cursor& c, const int32_t* __restrict__ tri_ei,
                                          const int32_t* __restrict__ tri_ej,
                                          const int32_t* __restrict__ tri_lm,
                                          const int4* __restrict__ items, int nitems,
                                          int slot) {
  Step s;
  s.valid = c.valid;
  if (!c.valid) return s;
  s.n = min(kStep, c.end - c.t0);
  s.target = c.target;
  const int t = c.t0 + min(slot, s.n - 1);
  s.ei = tri_ei[t];
  s.ej = tri_ej[t];
  s.lm = tri_lm[t];
  c.t0 += kStep;
  s.last = c.t0 >= c.end;
  if (s.last) {
    c.it += c.stride;
    open_item(c, items, nitems);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
pair_items_kernel(const T* __restrict__ hpl,
                  const T* __restrict__ inv_hll,
                  const int32_t* __restrict__ tri_ei,
                  const int32_t* __restrict__ tri_ej,
                  const int32_t* __restrict__ tri_lm,
                  const int4* __restrict__ items, int nitems,
                  T* __restrict__ out, double* __restrict__ scratch) {
  extern __shared__ __align__(16) double smem_[];
  T* const smem = reinterpret_cast<T*>(smem_);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* const buf = smem + warp * 2 * kStage;  // two stages
  const int slot = lane / kSplit;          // the lane's triple of the step
  const int i0 = (lane % kSplit) * kRows;  // the first product row it sums

  auto fetch = [&](Cursor& c) {
    return next_step(c, tri_ei, tri_ej, tri_lm, items, nitems, slot);
  };
  auto issue = [&](T* st, Step& s) {
    s.same = __all_sync(kFull, s.ei == s.ej);
    stage_rows<18, kHplRow, 2>(st, hpl, s.ei, lane);
    if (!s.same) stage_rows<18, kHplRow, 2>(st + kStep * kHplRow, hpl, s.ej, lane);
    stage_rows<9, 9, 1>(st + 2 * kStep * kHplRow, inv_hll, s.lm, lane);
  };

  // A pipeline of three steps: the indices of step n + 2 are being loaded
  // and the rows of step n + 1 copied while step n is multiplied.
  Cursor c;
  c.it = blockIdx.x * kWarps + warp;
  c.stride = gridDim.x * kWarps;
  open_item(c, items, nitems);
  Step cur = fetch(c);
  if (cur.valid) issue(buf, cur);
  asm volatile("cp.async.commit_group;" ::: "memory");
  Step nxt = fetch(c);
  int b = 0;

  double acc[kRows * 6];
#pragma unroll
  for (int q = 0; q < kRows * 6; ++q) acc[q] = 0.0;

  while (cur.valid) {
    T* st = buf + b * kStage;
    if (nxt.valid) issue(buf + (b ^ 1) * kStage, nxt);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const Step after = fetch(c);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();
    if (slot < cur.n) {
      const T* a = st + slot * kHplRow + i0 * 3;
      const T* bb = st + (cur.same ? 0 : kStep * kHplRow) + slot * kHplRow;
      const T* m = st + 2 * kStep * kHplRow + slot * 9;
      double mm[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) mm[q] = m[q];
      // W = Hpl[ei] (6x3) @ invHll (3x3), a row at a time, then
      // acc += W @ Hpl[ej]^T (6x6)
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const double a0 = a[i * 3], a1 = a[i * 3 + 1], a2 = a[i * 3 + 2];
        double w[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          w[k] = a0 * mm[k] + a1 * mm[3 + k] + a2 * mm[6 + k];
#pragma unroll
        for (int j = 0; j < 6; ++j)
          acc[i * 6 + j] += w[0] * static_cast<double>(bb[j * 3]) +
                            w[1] * static_cast<double>(bb[j * 3 + 1]) +
                            w[2] * static_cast<double>(bb[j * 3 + 2]);
      }
    }
    if (cur.last) {
      // a fixed tree over the lanes that sum the same rows
#pragma unroll
      for (int sh = 16; sh >= kSplit; sh >>= 1)
#pragma unroll
        for (int q = 0; q < kRows * 6; ++q)
          acc[q] += __shfl_down_sync(kFull, acc[q], sh);
      // lanes 0..kSplit-1 hold the item's sums: through the stage (every
      // lane is past its rows), as doubles, to a coalesced row
      double* const sums = reinterpret_cast<double*>(st);
      __syncwarp();
      if (lane < kSplit) {
#pragma unroll
        for (int q = 0; q < kRows * 6; ++q) sums[i0 * 6 + q] = acc[q];
      }
      __syncwarp();
      if (cur.target < 0) {
        double* row = scratch + static_cast<int64_t>(-1 - cur.target) * 36;
        row[lane] = sums[lane];
        if (lane < 4) row[32 + lane] = sums[32 + lane];
      } else {
        T* row = out + static_cast<int64_t>(cur.target) * 36;
        row[lane] = static_cast<T>(sums[lane]);
        if (lane < 4) row[32 + lane] = static_cast<T>(sums[32 + lane]);
      }
#pragma unroll
      for (int q = 0; q < kRows * 6; ++q) acc[q] = 0.0;
    }
    __syncwarp();  // the stage is free for the step after next
    cur = nxt;
    nxt = after;
    b ^= 1;
  }
}

// A block's row from its items' scratch rows, in item order; one thread an
// entry.  A single item was written by the item kernel; none gives zeros.
template <typename T>
__global__ void __launch_bounds__(256)
pair_finish_kernel(const int32_t* __restrict__ block_off, int64_t nnz,
                   const double* __restrict__ scratch,
                   T* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t blk = t / 36;
  if (blk >= nnz) return;
  const int q = static_cast<int>(t - blk * 36);
  const int c0 = block_off[blk], c1 = block_off[blk + 1];
  if (c1 - c0 == 1) return;
  double acc = 0.0;
  for (int c = c0; c < c1; ++c) acc += scratch[static_cast<int64_t>(c) * 36 + q];
  out[t] = static_cast<T>(acc);
}

template <typename T>
int pair_products(const void* hpl, const void* inv_hll, const void* tri_ei,
                  const void* tri_ej, const void* tri_lm, const void* items,
                  long long nitems, const void* block_off, long long nnz,
                  void* scratch, void* out, cudaStream_t st) {
  if (nitems > 0) {
    constexpr int kBytes = kWarps * 2 * kStage * sizeof(T);
    // once a process and type: the kernel's shared memory and the card's SM
    // count
    static int resident = 0;  // thread blocks the card holds at a time
    if (resident == 0) {
      cudaError_t err = cudaFuncSetAttribute(
          pair_items_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      int device = 0, sms = 0;
      err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
      resident = sms * kMinBlocks;
    }
    // a resident grid: every warp strides over the item list, so that long
    // and short items even out over a warp's share
    const long long blocks = std::min<long long>((nitems + kWarps - 1) / kWarps, resident);
    cudaError_t err;
    pair_items_kernel<T><<<static_cast<unsigned>(blocks), 32 * kWarps, kBytes, st>>>(
        static_cast<const T*>(hpl), static_cast<const T*>(inv_hll),
        static_cast<const int32_t*>(tri_ei), static_cast<const int32_t*>(tri_ej),
        static_cast<const int32_t*>(tri_lm), static_cast<const int4*>(items),
        static_cast<int>(nitems), static_cast<T*>(out),
        static_cast<double*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long threads = nnz * 36;
  pair_finish_kernel<T><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const int32_t*>(block_off), nnz,
      static_cast<const double*>(scratch), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tri_ei, tri_ej, tri_lm [T], items [nitems, 4] and block_off [nnz + 1] are
// the int32 plan of kernels/pairprod.py make_pair_plan; scratch [nitems, 36]
// f64 in either working type.  f32: 1 where Hpl, the inverses and the output
// are f32, 0 for f64.
extern "C" int tba_schur_pair_products(const void* hpl, const void* inv_hll,
                                       const void* tri_ei, const void* tri_ej,
                                       const void* tri_lm, const void* items,
                                       long long nitems, const void* block_off,
                                       long long nnz, int f32, void* scratch, void* out,
                                       void* stream) {
  if (nnz == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return f32 ? pair_products<float>(hpl, inv_hll, tri_ei, tri_ej, tri_lm, items, nitems,
                                    block_off, nnz, scratch, out, st)
             : pair_products<double>(hpl, inv_hll, tri_ei, tri_ej, tri_lm, items, nitems,
                                     block_off, nnz, scratch, out, st);
}
