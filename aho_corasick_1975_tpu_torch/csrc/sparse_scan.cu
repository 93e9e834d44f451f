// K7 sparse window count and K8 1-char bounded hits for sm_90a: one thread
// per live-block window (K7, K8 window form) or per stream (K8 stream
// form), each running the per-thread scan of ac_scan.cuh.
//
// K7 replaces ops/sparse.py:make_sparse_count, make_sparse_count_stepped
// and their _dev forms (the window gather _window_gather folded into the
// addressing: column c reads ext[idx[c]*L_blk + t] in place), and the
// elided counts of models/scanner.py:_elided_count_core
// (make_blocked_count / make_stepped_count over host-elided windows).
// K8 replaces ops/hits.py:make_blocked_hits[_stream|_raw] and
// ops/sparse.py:_window_hits_core (make_sparse_hits[_dev],
// make_elided_hits). Where the reference compacts a [T] hit mask into a
// buffer of max_hits slots (nonzero(size=max_hits), up to
// pow2(n_live*L_blk) on the prefilter's auto path), K8 runs twice: pass 1
// counts each column's hit positions, the wrapper takes their exclusive
// prefix sum (one 8-byte sync gives the total), and pass 2 re-runs the
// chain and writes each hit at its column's offset, so the output is
// exactly 8 bytes per matching position.
//
// Bound: a dependent chain of gathers per symbol (dflat, then nb_out; one
// packed gather per k symbols for K7 stepped), so load latency. With
// gather = 1 a column's rows are contiguous and its window is a 0.5-2 KB
// read; the elided windows are time-major, so a warp's symbol loads
// coalesce.
#include <cuda_runtime.h>

#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void sparse_count_kernel(AcScanArgs a) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < a.B) ac_sparse_count_column(a, c);
}

__global__ void sparse_count_stepped_kernel(AcScanArgs a) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < a.B) ac_sparse_count_stepped_column(a, c);
}

template <typename T>
__global__ void dense_hits_kernel(AcScanArgs a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) ac_dense_hits_stream<T>(a, b);
}

__global__ void window_hits_kernel(AcScanArgs a) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < a.B) ac_window_hits_column(a, c);
}

}  // namespace

extern "C" int ac_sparse_count(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  sparse_count_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ac_sparse_count_stepped(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  sparse_count_stepped_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}

extern "C" int ac_dense_hits(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    dense_hits_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a);
  else
    dense_hits_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ac_window_hits(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  window_hits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
