// K3 stepped count, K4 stepped emit, K5 stepped count_many and K9 the
// two-table stepped count for sm_90a: one thread per stream (K5, K9's
// batch form: per batch column), each running the per-thread scan of
// ac_scan.cuh.
//
// K3 replaces ops/multistep.py:stepped_count_core (make_stepped_count_stream
// / _raw), the default count. K4 replaces ops/hits.py:_stepped_emit_scan
// (make_stepped_hits_scan / _raw), phase A of retrieval. K5 replaces
// ops/multistep.py:_stepped_count_many_body / make_stepped_count_many
// (split_docs_layout folded into the addressing), count_many's default: the
// K3 recurrence over the [L, B] batch, whose symbol loads coalesce.
//
// K9 replaces ops/multistep.py:make_stepped_count_unpacked_stream (stream
// form, ids or raw) and make_stepped_count_unpacked (count_many's batch,
// layout 1): K3's body over the two tables delta_k and cnt_k, where
// (state, count) need more than 31 bits; two independent loads per gram
// step, the next index depending on the first.
//
// Bound: one dependent gather of the packed k-gram table per k symbols
// per thread, so load latency. The table (28 MB for the 1,000-keyword
// byte dictionary at k = 3) fits in the H100's 50 MB L2; the 10,000-keyword
// batch-scoring dictionary's k = 1 table (62 MB) does not.
#include <cuda_runtime.h>

#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void stepped_count_kernel(AcScanArgs a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) ac_stepped_count_stream<T>(a, b);
}

template <typename T>
__global__ void stepped_emit_kernel(AcScanArgs a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) ac_stepped_emit_stream<T>(a, b);
}

template <typename T>
__global__ void stepped_count_many_kernel(AcScanArgs a) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col < a.B) ac_stepped_count_many_column<T>(a, col);
}

template <typename T>
__global__ void stepped_count_2t_kernel(AcScanArgs a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) ac_stepped_count_2t_stream<T>(a, b);
}

__global__ void stepped_count_2t_batch_kernel(AcScanArgs a) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col < a.B) ac_stepped_count_2t_column(a, col);
}

}  // namespace

extern "C" int ac_stepped_count(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    stepped_count_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a);
  else
    stepped_count_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ac_stepped_emit(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    stepped_emit_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a);
  else
    stepped_emit_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ac_stepped_count_many(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    stepped_count_many_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a);
  else
    stepped_count_many_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ac_stepped_count_2t(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->layout == 1)
    stepped_count_2t_batch_kernel<<<grid, kThreads, 0, st>>>(*a);
  else if (a->ext_u8)
    stepped_count_2t_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a);
  else
    stepped_count_2t_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}
