// K1 dense count, K2 dense states (stream, one-thread and time-major modes)
// and K6 dense count_many for sm_90a: one thread per stream (K6: per batch
// column), each running the per-thread scan of ac_scan.cuh.
//
// K1 replaces ops/scan_pallas.py:make_pallas_blocked_count (the JAX
// package's only Pallas kernel) and ops/scan_xla.py:make_blocked_count_stream
// / _raw. It returns per-stream int32 totals, which the host sums in int64;
// the Pallas kernel's single int32 sum could wrap.
// K2 replaces ops/scan_xla.py:make_blocked_scan_stream / _raw.
// K6 replaces ops/scan_xla.py:_count_many_body / make_blocked_count_many
// (split_docs_layout folded into the addressing): K1's recurrence over the
// [L, B] batch, the count_many path without a packed table. Its symbol
// loads coalesce (neighbouring threads read neighbouring documents).
//
// Bound: a dependent chain of two gathers per symbol (dflat, then nb_out)
// per thread, so load latency; dflat and nb_out are read through L1/L2.
#include <cuda_runtime.h>

#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void dense_count_kernel(AcScanArgs a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) ac_dense_count_stream<T>(a, b);
}

template <typename T>
__global__ void dense_states_kernel(AcScanArgs a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) ac_dense_states_stream<T>(a, b);
}

template <typename T>
__global__ void dense_count_many_kernel(AcScanArgs a) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col < a.B) ac_dense_count_many_column<T>(a, col);
}

template <typename T>
__global__ void dense_states_tm_kernel(AcScanArgs a) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < a.n_docs) ac_dense_states_tm_column<T>(a, j);
}

}  // namespace

extern "C" int ac_dense_count(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    dense_count_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a);
  else
    dense_count_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ac_dense_states(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    dense_states_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a);
  else
    dense_states_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ac_dense_count_many(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    dense_count_many_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a);
  else
    dense_count_many_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

// K2 over a time-major [L, n_docs] batch (ops/scan_xla.py:make_blocked_scan).
extern "C" int ac_dense_states_tm(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->n_docs + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    dense_states_tm_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a);
  else
    dense_states_tm_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" const char* ac_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
