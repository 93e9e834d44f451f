// K10 MXU count and K11 hybrid count for sm_90a: the automaton's lookup as
// an int8 tensor-core product (mma.sync m16n8k32), one warp per 16
// streams, batch columns or windows, each warp running ac_mxu_warp of
// ac_scan.cuh.
//
// K10 replaces ops/scan_mxu.py:mxu_count_core in every form the JAX
// scanner runs: make_mxu_count_stream / _raw (layout 0), make_mxu_count_many
// (layout 1, split_docs_layout folded into the addressing), and
// make_mxu_count_halo and ops/sparse.py:make_sparse_count_mxu[_dev] over
// host-elided windows or the live-block index list (layout 2).
// K11 replaces ops/scan_hybrid.py:hybrid_count_core (make_hybrid_count_stream
// / _raw): one launch whose first blocks are gather blocks, one thread per
// column of [0, B1) running K3's body, and whose other blocks are MMA
// blocks, one warp per 16 columns of [B1, B) running K10's.
//
// Bound: each step of a warp is a chain of dependent tile products (the
// next state comes out of this step's D), a few tiles a step where the 16
// states fall in few 32-state tiles. Measured against the operations the
// engine's dense product counts (2 * S_pad * n_planes * V a symbol), the
// kernel is bound neither by those operations nor by bytes but by this
// per-step latency; the planes (at most 512 x 4 x 257 bytes for K10, about
// 161 KB for the slice's hybrid) are read through L1/L2. Shared memory
// holds only each warp's 16 states, symbols and digits.
#include <cuda_runtime.h>

#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename Layout>
__global__ void mxu_count_kernel(AcScanArgs a) {
  __shared__ AcMxuWarp warps[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col0 = ((int64_t)blockIdx.x * kWarps + warp) * 16;
  if (col0 < a.B) ac_mxu_warp<Layout>(a, warps[warp], lane, col0);
}

template <typename T>
__global__ void hybrid_count_kernel(AcScanArgs a, int32_t gather_blocks) {
  __shared__ AcMxuWarp warps[kWarps];
  if ((int32_t)blockIdx.x < gather_blocks) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b < a.B1) ac_stepped_count_stream<T>(a, b);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col0 =
      a.B1 + ((int64_t)(blockIdx.x - gather_blocks) * kWarps + warp) * 16;
  if (col0 < a.B) ac_mxu_warp<AcStreamLayout<T> >(a, warps[warp], lane, col0);
}

int warp_blocks(int64_t columns) {
  return (int)((columns + 16 * kWarps - 1) / (16 * kWarps));
}

}  // namespace

extern "C" int ac_mxu_count(const AcScanArgs* a, void* stream) {
  const dim3 grid(warp_blocks(a->B));
  cudaStream_t st = (cudaStream_t)stream;
  if (a->layout == 2)
    mxu_count_kernel<AcWinLayout><<<grid, kThreads, 0, st>>>(*a);
  else if (a->layout == 1 && a->ext_u8)
    mxu_count_kernel<AcBatchLayout<uint8_t> ><<<grid, kThreads, 0, st>>>(*a);
  else if (a->layout == 1)
    mxu_count_kernel<AcBatchLayout<int32_t> ><<<grid, kThreads, 0, st>>>(*a);
  else if (a->ext_u8)
    mxu_count_kernel<AcStreamLayout<uint8_t> ><<<grid, kThreads, 0, st>>>(*a);
  else
    mxu_count_kernel<AcStreamLayout<int32_t> ><<<grid, kThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ac_hybrid_count(const AcScanArgs* a, void* stream) {
  const int32_t gather_blocks = (int32_t)((a->B1 + kThreads - 1) / kThreads);
  const dim3 grid(gather_blocks + warp_blocks((int64_t)a->B - a->B1));
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    hybrid_count_kernel<uint8_t><<<grid, kThreads, 0, st>>>(*a, gather_blocks);
  else
    hybrid_count_kernel<int32_t><<<grid, kThreads, 0, st>>>(*a, gather_blocks);
  return (int)cudaGetLastError();
}
