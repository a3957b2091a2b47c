// Kernel B2: exact per-edge state gather, out[e, k] = table[idx[e], k], in
// the working type (f64, or f32 in f32 mode: a copy, so exact in either).
//
// Replaces: cuda_bundle_adjustment_tpu/pallas/onehot.py, expand ->
// _expand_call (pallas_call at :243).  On the TPU a gather is a slow
// per-row operation, so the Pallas kernel selects rows with a one-hot MXU
// product over a DMA'd window of the table, splitting f64 into three f32
// summands to stay exact.  H100 has native f64 loads, so none of that
// carries over: this is a plain indexed copy.
//
// Bound on this card: device-memory bytes.  The pose table [P, 12] (127 KB at
// P = 1322) and landmark table [L, 3] (3.2 MB at L = 133k) stay in the 50 MB
// L2, so the cost is writing E * K * 8 bytes (54 MB for the pose state at
// E = 561k; half in f32) plus reading the int64 indices.
//
// Design: one thread per output element, consecutive threads on consecutive
// output addresses (coalesced stores); the table reads are L2 hits.  An
// index outside [0, M) yields a zero row, the sentinel convention of the
// Pallas kernel (onehot.py:16-18).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table,
                                   const int64_t* __restrict__ idx,
                                   T* __restrict__ out, int64_t M,
                                   int64_t E, int K) {
  const int64_t n = E * K;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t e = i / K;
    const int k = static_cast<int>(i - e * K);
    const int64_t r = idx[e];
    out[i] = (r >= 0 && r < M) ? table[r * K + k] : T(0);
  }
}

template <typename T>
int launch(const void* table, const void* idx, void* out, long long M,
           long long E, int K, void* stream) {
  const long long n = E * static_cast<long long>(K);
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  gather_rows_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int64_t*>(idx),
      static_cast<T*>(out), M, E, K);
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
