// Kernel B2: exact per-edge state gather, out[e, k] = table[idx[e], k], in
// the working type (f64, or f32 in f32 mode: a copy, so exact in either).
//
// Replaces: cuda_bundle_adjustment_tpu/pallas/onehot.py, expand (:251) ->
// _expand_call (pallas_call at :243).  On the TPU a gather is a slow
// per-row operation, so the Pallas kernel selects rows with a one-hot MXU
// product over a DMA'd window of the table, splitting f64 into three f32
// summands to stay exact.  H100 has native f64 loads, so none of that
// carries over: this is a plain indexed copy.
//
// Bound on this card: device-memory bytes.  The output is written once, the
// int64 indices and the table read once.  At kitti00_mono (E = 559679) the
// pose gather [1322, 12] moves 58.3 MB in f64 (31.4 MB in f32), the
// landmark gather [133383, 3] 21.1 MB (12.8 MB); both tables stay in the
// 50 MB L2 (127 KB and 3.2 MB), so the output's stores and the index reads
// are what reach device memory.
//
// Design: the output [E, K] is one flat run of bytes, cut into 16-byte
// chunks; a thread writes a chunk with one double2 / float4 store, and
// neighbouring threads write neighbouring chunks, so a warp's store covers
// 512 consecutive bytes.  A first port ran a thread an output element: every
// element divided its flat index by a run-time K in 64-bit arithmetic (a
// subroutine of dozens of instructions on this card), reloaded idx[e] and
// stored 4 or 8 bytes, which made it bound by instructions, not bytes.  Here
// the two widths the solver gathers, K = 12 (the pose state) and K = 3 (the
// landmarks), are compile-time constants: the chunk's row is a 32-bit
// multiply and shift, and each row's index is read once a thread. At K = 12
// a chunk never straddles a row (96 B or 48 B a row), so it is one index and
// one 16-byte load from the table; at K = 3 (24 B or 12 B a row) a chunk
// spans two rows, so up to two indices and 2 (f64) or 4 (f32) element loads.
// Any other K takes the same walk with K at run time (one 32-bit division a
// chunk).  A table whose address is not 16-byte aligned takes element loads
// at K = 12 (the launcher chooses).  The last chunk, if E * K * sizeof(T) is
// not a multiple of 16, is stored element by element. The chunks are stored
// with __stcs (evict first): the pose state's output (54 MB in f64 at
// kitti00_mono) is larger than L2, and plain stores that let it push the
// table and the indices out took 0.0234-0.0249 ms on the device against
// 0.0183-0.0188.  Two chunks a thread, a block's two rounds interleaved so
// that each keeps a warp's stores on consecutive addresses, keep more loads
// in flight: 0.153 ms against 0.170 for one at the city-scale pose gather
// (401 MB), within 1-10% of one at kitti00_mono. Four chunks, and a grid of
// 8 or 16 blocks an SM that strides over the output, were no faster (an H100
// at 700 W, tools/gather_variants.py).  No shared memory, atomics or
// synchronisation.  An index outside [0, M) yields a zero row, the sentinel
// convention of the Pallas kernel (onehot.py:16-18).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// 16-byte chunks a thread (the design note above)
constexpr int kChunksPerThread = 2;

// a 16-byte chunk of the output and its elements
template <typename T>
struct Chunk;
template <>
struct Chunk<double> {
  using type = double2;
  static __device__ __forceinline__ double2 pack(const double* v) {
    return make_double2(v[0], v[1]);
  }
};
template <>
struct Chunk<float> {
  using type = float4;
  static __device__ __forceinline__ float4 pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// the V = 16 / sizeof(T) elements of output chunk c (all below E * K).
// KC: the row width at compile time, or 0 for the run-time width K.
// kVecTable: the chunk lies in one row and the table is 16-byte aligned.
template <typename T, int KC, bool kVecTable>
__device__ __forceinline__ typename Chunk<T>::type fetch_chunk(
    const T* __restrict__ table, const int64_t* __restrict__ idx,
    unsigned long long M, unsigned K_rt, unsigned c) {
  constexpr int V = 16 / sizeof(T);
  using C = typename Chunk<T>::type;
  T v[V];
  const unsigned K = KC > 0 ? KC : K_rt;
  const unsigned i0 = c * V;
  unsigned e = i0 / K;
  unsigned k = i0 - e * K;
  if constexpr (KC > 0 && KC % V == 0) {
    // the chunk lies in one row
    const unsigned long long r = static_cast<unsigned long long>(idx[e]);
    if (r < M) {
      const T* src = table + static_cast<size_t>(r) * KC + k;
      if constexpr (kVecTable) {
        return *reinterpret_cast<const C*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = src[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = T(0);
    }
  } else {
    // walk the chunk's rows, each row's index read once; a negative index
    // is a large unsigned one, so one comparison rejects both sides
    unsigned long long r = static_cast<unsigned long long>(idx[e]);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = r < M ? table[static_cast<size_t>(r) * K + k] : T(0);
      if (j + 1 < V && ++k == K) {
        k = 0;
        r = static_cast<unsigned long long>(idx[++e]);
      }
    }
  }
  return Chunk<T>::pack(v);
}

template <typename T, int KC, bool kVecTable>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, const int64_t* __restrict__ idx,
                   T* __restrict__ out, unsigned long long M, unsigned n,
                   unsigned K_rt) {
  constexpr int V = 16 / sizeof(T);
  using C = typename Chunk<T>::type;
  constexpr unsigned per_block = kThreads * kChunksPerThread;
  const unsigned full = n / V;  // whole chunks
  const unsigned chunks = (n + V - 1) / V;
  // one trip: the launcher's grid covers the output
  for (unsigned base = blockIdx.x * per_block + threadIdx.x; base < chunks;
       base += gridDim.x * per_block) {
    C w[kChunksPerThread];
#pragma unroll
    for (int u = 0; u < kChunksPerThread; ++u) {
      const unsigned c = base + u * kThreads;
      if (c < full) w[u] = fetch_chunk<T, KC, kVecTable>(table, idx, M, K_rt, c);
    }
#pragma unroll
    for (int u = 0; u < kChunksPerThread; ++u) {
      const unsigned c = base + u * kThreads;
      if (c < full) {
        __stcs(reinterpret_cast<C*>(out) + c, w[u]);
      } else if (c == full) {
        // the ragged tail: fewer than V elements, one at a time
        const unsigned K = KC > 0 ? KC : K_rt;
        for (unsigned i = c * V; i < n; ++i) {
          const unsigned e = i / K;
          const unsigned long long r = static_cast<unsigned long long>(idx[e]);
          out[i] = r < M ? table[static_cast<size_t>(r) * K + (i - e * K)] : T(0);
        }
      }
    }
  }
}

template <typename T, int KC, bool kVecTable>
void run(const void* table, const void* idx, void* out, long long M, unsigned n,
         unsigned K, cudaStream_t stream) {
  constexpr unsigned V = 16 / sizeof(T);
  constexpr unsigned per_block = kThreads * kChunksPerThread;
  const unsigned chunks = (n + V - 1) / V;
  const unsigned blocks = (chunks + per_block - 1) / per_block;
  gather_rows_kernel<T, KC, kVecTable><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int64_t*>(idx),
      static_cast<T*>(out), static_cast<unsigned long long>(M), n, K);
}

template <typename T>
int launch(const void* table, const void* idx, void* out, long long M,
           long long E, int K, void* stream) {
  const long long n = E * static_cast<long long>(K);
  if (n == 0) return 0;
  // the wrapper's contract: 32-bit element and row indices, a fresh output
  if (n > 0x7fffffffLL || M > 0x7fffffffLL || M < 0 || K <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned un = static_cast<unsigned>(n);
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0;
  if (K == 12) {
    if (aligned)
      run<T, 12, true>(table, idx, out, M, un, 12, s);
    else
      run<T, 12, false>(table, idx, out, M, un, 12, s);
  } else if (K == 3) {
    run<T, 3, false>(table, idx, out, M, un, 3, s);
  } else {
    run<T, 0, false>(table, idx, out, M, un, static_cast<unsigned>(K), s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32: 1 for f32 table and output, 0 for f64
extern "C" int tba_gather_rows(const void* table, const void* idx, void* out,
                               long long M, long long E, int K, int f32,
                               void* stream) {
  return f32 ? launch<float>(table, idx, out, M, E, K, stream)
             : launch<double>(table, idx, out, M, E, K, stream);
}
