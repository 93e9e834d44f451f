// K10 MXU count and K11 hybrid count for sm_90a: the automaton's lookup as
// an int8 tensor-core product (mma.sync m16n8k32) keyed by (state, letter),
// one warp per R streams, batch columns or windows, each warp running
// ac_mxu_warp of ac_scan.cuh.
//
// K10 replaces ops/scan_mxu.py:mxu_count_core in every form the JAX
// scanner runs: make_mxu_count_stream / _raw (layout 0), make_mxu_count_many
// (layout 1, split_docs_layout folded into the addressing), and
// make_mxu_count_halo and ops/sparse.py:make_sparse_count_mxu[_dev] over
// host-elided windows or the live-block index list (layout 2).
// K11 replaces ops/scan_hybrid.py:hybrid_count_core (make_hybrid_count_stream
// / _raw): one launch whose first blocks are MMA blocks, one warp per R
// columns of [B1, B) running K10's body, and whose other blocks are gather
// blocks, one thread per column of [0, B1) running K3's. The MMA blocks take
// the lowest indices so that their longer chains start first.
//
// Bound: a warp's steps form one chain (the next key comes out of this
// step's D), each step a vote, one product per distinct 32-key tile among
// the warp's R rows (at R = 1 one product and no vote), and two shuffles.
// Against the operations the data needs (one product per 16 rows and step,
// the densest the instruction allows) and the bytes it reads, the kernel
// is bound by this per-step chain and, with many warps an SM (K10's 16,384
// streams), by the instructions they issue. What the design does about
// it: every row's state, letters and total stay in registers, one product
// serves all planes, the rows per warp R are one constant per kernel
// chosen on the card (AC_K10_ROWS, AC_K11_ROWS in ac_scan.cuh), the
// symbols are loaded AC_MXU_AHEAD steps ahead, and planes_t and the raw
// LUT are read from shared memory where they fit: the planes unless their
// bytes would cost the launch a wave of blocks (the hybrid slice's 161 KB,
// one block per SM, would), then through L1 from device memory.
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLutSmem = 4096;   // LUT entries served from shared memory

#define AC_TRY(x)                          \
  do {                                     \
    const cudaError_t e_ = (x);            \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

// A block of MMA warps over the columns from col_base: planes_t copied to
// shared memory when pt_bytes > 0, the LUT when lut_n > 0.
template <int R, typename Layout>
__device__ __forceinline__ void mxu_block(AcScanArgs a, int64_t col_base,
                                          int32_t pt_bytes, int32_t lut_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int8_t* pt = a.planes_t;
  if (pt_bytes > 0) {
    const uint4* src = (const uint4*)a.planes_t;
    uint4* dst = (uint4*)smem;
    for (int i = threadIdx.x; i < pt_bytes / 16; i += kThreads) dst[i] = src[i];
    pt = (const int8_t*)smem;
  }
  if (lut_n > 0) {
    int32_t* lut = (int32_t*)(smem + pt_bytes);
    for (int i = threadIdx.x; i < lut_n; i += kThreads) lut[i] = a.lut[i];
    a.lut = lut;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col0 = col_base + (int64_t)warp * R;
  if (col0 < a.B) ac_mxu_warp<R, Layout>(a, pt, lane, col0);
}

template <int R, typename Layout>
__global__ void __launch_bounds__(kThreads)
    mxu_count_kernel(AcScanArgs a, int32_t pt_bytes, int32_t lut_n) {
  mxu_block<R, Layout>(a, (int64_t)blockIdx.x * kWarps * R, pt_bytes, lut_n);
}

template <int R, typename T>
__global__ void __launch_bounds__(kThreads)
    hybrid_count_kernel(AcScanArgs a, int32_t mma_blocks, int32_t pt_bytes,
                        int32_t lut_n) {
  if ((int32_t)blockIdx.x >= mma_blocks) {
    const int64_t b =
        (int64_t)(blockIdx.x - mma_blocks) * kThreads + threadIdx.x;
    if (b < a.B1) ac_stepped_count_stream<T>(a, b);
    return;
  }
  mxu_block<R, AcStreamLayout<T> >(
      a, a.B1 + (int64_t)blockIdx.x * kWarps * R, pt_bytes, lut_n);
}

// The occupancy of a kernel on a device at a block's dynamic shared memory
// with and without planes_t (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// queried once per kernel, device and size: a run launches a kernel many
// times over the same tables. `set` is the largest dynamic shared memory
// allowed so far (cudaFuncAttributeMaxDynamicSharedMemorySize), only ever
// raised, so that every cached size stays allowed.
struct SmemFit {
  int sms = 0, with = 0, without = 0;
};
std::mutex plan_mu;
std::map<std::tuple<const void*, int, int64_t, int64_t>, SmemFit> plan_fits;
std::map<std::pair<const void*, int>, int64_t> plan_set;

template <typename Kernel>
cudaError_t smem_fit(Kernel kernel, int64_t base, int64_t pt, SmemFit* fit) {
  int dev = 0;
  AC_TRY(cudaGetDevice(&dev));
  const void* key = (const void*)kernel;
  std::lock_guard<std::mutex> hold(plan_mu);
  const auto it = plan_fits.find(std::make_tuple(key, dev, base, pt));
  if (it != plan_fits.end()) {
    *fit = it->second;
    return cudaSuccess;
  }
  int optin = 0;
  AC_TRY(cudaDeviceGetAttribute(&fit->sms, cudaDevAttrMultiProcessorCount,
                                dev));
  AC_TRY(cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (base + pt <= optin) {
    int64_t& set = plan_set[std::make_pair(key, dev)];
    if (base + pt > set) {
      AC_TRY(cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)(base + pt)));
      set = base + pt;
    }
    AC_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit->with, kernel,
                                                         kThreads, base + pt));
    AC_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit->without, kernel,
                                                         kThreads, base));
  }
  plan_fits[std::make_tuple(key, dev, base, pt)] = *fit;
  return cudaSuccess;
}

// The dynamic shared memory of a launch of `grid` blocks: the LUT where it
// has at most kLutSmem entries, and planes_t where it fits a block and
// leaves the launch as many waves of blocks as it has without it.
template <typename Kernel>
cudaError_t smem_plan(Kernel kernel, const AcScanArgs& a, int64_t grid,
                      int32_t* pt_bytes, int32_t* lut_n) {
  *lut_n = (a.lut != nullptr && a.n_lut <= kLutSmem) ? a.n_lut : 0;
  *pt_bytes = 0;
  const int64_t base = 4 * (int64_t)*lut_n;
  const int64_t pt = (int64_t)a.n_planes * ac_key_stride(a);
  SmemFit fit;
  AC_TRY(smem_fit(kernel, base, pt, &fit));
  const int64_t per_with = (int64_t)fit.sms * fit.with;
  const int64_t per_without = (int64_t)fit.sms * fit.without;
  if (fit.with > 0 && fit.without > 0 &&
      (grid + per_with - 1) / per_with <=
          (grid + per_without - 1) / per_without)
    *pt_bytes = (int32_t)pt;
  return cudaSuccess;
}

template <typename Layout>
cudaError_t launch_mxu(const AcScanArgs& a, cudaStream_t st) {
  constexpr int R = AC_K10_ROWS;
  const auto kernel = mxu_count_kernel<R, Layout>;
  const int64_t grid = (a.B + kWarps * R - 1) / (kWarps * R);
  if (grid == 0) return cudaSuccess;
  int32_t pt_bytes = 0, lut_n = 0;
  AC_TRY(smem_plan(kernel, a, grid, &pt_bytes, &lut_n));
  kernel<<<(unsigned)grid, kThreads, pt_bytes + 4 * lut_n, st>>>(a, pt_bytes,
                                                                lut_n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hybrid(const AcScanArgs& a, cudaStream_t st) {
  constexpr int R = AC_K11_ROWS;
  const auto kernel = hybrid_count_kernel<R, T>;
  const int64_t mma_blocks =
      ((int64_t)a.B - a.B1 + kWarps * R - 1) / (kWarps * R);
  const int64_t grid = mma_blocks + (a.B1 + kThreads - 1) / kThreads;
  if (grid == 0) return cudaSuccess;
  int32_t pt_bytes = 0, lut_n = 0;
  AC_TRY(smem_plan(kernel, a, grid, &pt_bytes, &lut_n));
  kernel<<<(unsigned)grid, kThreads, pt_bytes + 4 * lut_n, st>>>(
      a, (int32_t)mma_blocks, pt_bytes, lut_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ac_mxu_count(const AcScanArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a->layout == 2) return (int)launch_mxu<AcWinLayout>(*a, st);
  if (a->layout == 1 && a->ext_u8)
    return (int)launch_mxu<AcBatchLayout<uint8_t> >(*a, st);
  if (a->layout == 1) return (int)launch_mxu<AcBatchLayout<int32_t> >(*a, st);
  if (a->ext_u8) return (int)launch_mxu<AcStreamLayout<uint8_t> >(*a, st);
  return (int)launch_mxu<AcStreamLayout<int32_t> >(*a, st);
}

extern "C" int ac_hybrid_count(const AcScanArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8) return (int)launch_hybrid<uint8_t>(*a, st);
  return (int)launch_hybrid<int32_t>(*a, st);
}
