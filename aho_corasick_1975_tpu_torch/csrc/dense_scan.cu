// K1 dense count, K2 dense states (stream, one-thread and time-major modes)
// and K6 dense count_many for sm_90a.
//
// K1 replaces ops/scan_pallas.py:make_pallas_blocked_count (the JAX
// package's only Pallas kernel) and ops/scan_xla.py:make_blocked_count_stream
// / _raw. It returns per-stream int32 totals, which the host sums in int64;
// the Pallas kernel's single int32 sum could wrap. It runs K3's sub-stream
// lanes (ac_stepped_lanes) at k = 1 over the 1-char tables
// (AcDenseTable): each stream split into P sub-streams, each warmed up over
// warm_steps symbols from the root, in consecutive lanes reduced by warp
// shuffles; the stream's symbols loaded a group ahead as aligned 16-byte
// vectors (AcVecGroup), the LUT in shared memory, and the tables staged on
// the SM where they fit (ac_dense_launch), else read through the
// read-only path.
// K2 replaces ops/scan_xla.py:make_blocked_scan_stream / _raw.
// K6 replaces ops/scan_xla.py:_count_many_body / make_blocked_count_many
// (split_docs_layout folded into the addressing): K1's recurrence over the
// [L, B] batch, one thread a column, the count_many path without a packed
// table. Its symbol loads coalesce (neighbouring threads read neighbouring
// documents).
//
// Bound: a dependent chain of one table gather per symbol per thread
// (dflat; nb_out's gather hangs off it), so load latency. K2 and K6 keep
// one thread a stream or column.
#include <cuda_runtime.h>

#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;

// K1: each warp of the grid's loop takes 32 of the launch's B*P
// sub-streams (ac_stepped_lanes at k = 1); the loop's bound is the same
// in every lane of a warp, so every lane reaches every shuffle.
template <typename Layout, typename Table>
__device__ __forceinline__ void dense_count_lanes(const AcScanArgs& a,
                                                  const Table& table,
                                                  int32_t P) {
  const int64_t n = (int64_t)a.B * P;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g0 = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       g0 < n; g0 += stride)
    ac_stepped_lanes<1, Layout>(a, table, a.B, P, g0, threadIdx.x & 31);
}

template <typename Layout, bool OnSm>
__global__ void __launch_bounds__(OnSm ? kDenseSmThreads : kDenseThreads)
    dense_count_kernel(AcScanArgs a, int32_t P, int32_t lut_n, int32_t) {
  extern __shared__ int32_t smem[];
  ac_lut_to_smem(a, lut_n, smem);
  if constexpr (OnSm)
    dense_count_lanes<Layout>(a, ac_dense_sm_table(a, smem + lut_n), P);
  else
    dense_count_lanes<Layout>(a, AcDenseTable<int32_t>::make(a), P);
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

template <typename T>
int dense_count(const AcScanArgs* a, void* stream) {
  return (int)ac_dense_launch(
      *a, dense_count_kernel<AcStreamLayout<T>, true>,
      dense_count_kernel<AcStreamLayout<T>, false>, 0, (cudaStream_t)stream,
      nullptr);
}

}  // namespace

extern "C" int ac_dense_count(const AcScanArgs* a, void* stream) {
  return a->ext_u8 ? dense_count<uint8_t>(a, stream)
                   : dense_count<int32_t>(a, stream);
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
