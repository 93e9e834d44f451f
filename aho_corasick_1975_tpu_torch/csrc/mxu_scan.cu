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
// blocks, running K3's sub-streams over the columns of [0, B1) (P of them
// a column, as stepped_scan.cu picks P). The MMA blocks take the lowest
// indices so that their longer chains start first.
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
#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

// K11: MMA blocks first, then gather blocks running K3's sub-streams
// (ac_stepped_lanes, P of them a column of [0, B1)) with the LUT in shared
// memory.
template <int R, typename T, int K>
__global__ void __launch_bounds__(kThreads)
    hybrid_count_kernel(AcScanArgs a, int32_t mma_blocks, int32_t P,
                        int32_t pt_bytes, int32_t lut_n) {
  if ((int32_t)blockIdx.x >= mma_blocks) {
    extern __shared__ __align__(16) unsigned char smem[];
    ac_lut_to_smem(a, lut_n, (int32_t*)smem);
    const int64_t t =
        (int64_t)(blockIdx.x - mma_blocks) * kThreads + threadIdx.x;
    ac_stepped_lanes<K, AcStreamLayout<T> >(a, ac_packed(a), a.B1, P,
                                             t & ~(int64_t)31,
                                             threadIdx.x & 31);
    return;
  }
  mxu_block<R, AcStreamLayout<T> >(
      a, a.B1 + (int64_t)blockIdx.x * kWarps * R, pt_bytes, lut_n);
}

// The occupancy of a kernel at a block's dynamic shared memory with and
// without planes_t (ac_occupancy, cached; the limit raised by
// ac_allow_smem).
struct SmemFit {
  int sms = 0, with = 0, without = 0;
};

template <typename Kernel>
cudaError_t smem_fit(Kernel kernel, int64_t base, int64_t pt, SmemFit* fit) {
  const void* key = (const void*)kernel;
  AcOccupancy occ;
  AC_TRY(ac_occupancy(key, kThreads, base, &occ));
  fit->sms = occ.sms;
  fit->without = occ.blocks;
  fit->with = 0;
  AcDevice d;
  AC_TRY(ac_device(&d));
  if (base + pt > d.optin) return cudaSuccess;
  AC_TRY(ac_allow_smem(key, base + pt));
  AC_TRY(ac_occupancy(key, kThreads, base + pt, &occ));
  fit->with = occ.blocks;
  return cudaSuccess;
}

// The dynamic shared memory of a launch of `grid` blocks: the LUT where it
// has at most kLutSmem entries, and planes_t where it fits a block and
// leaves the launch as many waves of blocks as it has without it.
template <typename Kernel>
cudaError_t smem_plan(Kernel kernel, const AcScanArgs& a, int64_t grid,
                      int32_t* pt_bytes, int32_t* lut_n) {
  *lut_n = ac_lut_entries(a);
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

// K11's gather half takes K3's split: P from the launch's split field, or
// from ac_pick_split over B1 columns at the kernel's occupancy without the
// planes in shared memory; then ceil(B1 * P / kThreads) gather blocks.
template <typename T, int K>
cudaError_t launch_hybrid(const AcScanArgs& a, cudaStream_t st) {
  constexpr int R = AC_K11_ROWS;
  const auto kernel = hybrid_count_kernel<R, T, K>;
  const int64_t mma_blocks =
      ((int64_t)a.B - a.B1 + kWarps * R - 1) / (kWarps * R);
  int64_t slots[AC_SPLITS];
  AC_TRY(ac_slots(kernel, kThreads, 4 * (int64_t)ac_lut_entries(a),
                  &slots[0]));
  for (int i = 1; i < AC_SPLITS; ++i) slots[i] = slots[0];
  const int P = ac_launch_split(a, a.B1, slots, AC_MAX_SPLIT);
  if (P == 0) return cudaErrorInvalidValue;
  const int64_t grid =
      mma_blocks + ((int64_t)a.B1 * P + kThreads - 1) / kThreads;
  if (grid == 0) return cudaSuccess;
  int32_t pt_bytes = 0, lut_n = 0;
  AC_TRY(smem_plan(kernel, a, grid, &pt_bytes, &lut_n));
  kernel<<<(unsigned)grid, kThreads, pt_bytes + 4 * lut_n, st>>>(
      a, (int32_t)mma_blocks, P, pt_bytes, lut_n);
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
  if (a->ext_u8) AC_WITH_K(a->k, return (int)launch_hybrid<uint8_t, K>(*a, st));
  AC_WITH_K(a->k, return (int)launch_hybrid<int32_t, K>(*a, st));
  return 0;
}
