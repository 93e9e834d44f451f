// K3 stepped count, K4 stepped emit, K5 stepped count_many and K9 the
// two-table stepped count for sm_90a, each running the code of ac_scan.cuh.
//
// K3 replaces ops/multistep.py:stepped_count_core (make_stepped_count_stream
// / _raw), the default count. K4 replaces ops/hits.py:_stepped_emit_scan
// (make_stepped_hits_scan / _raw), phase A of retrieval. K5 replaces
// ops/multistep.py:_stepped_count_many_body / make_stepped_count_many
// (split_docs_layout folded into the addressing), count_many's default: the
// K3 recurrence over the [L, B] batch.
//
// K9 replaces ops/multistep.py:make_stepped_count_unpacked_stream (stream
// form, ids or raw) and make_stepped_count_unpacked (count_many's batch,
// layout 1): K3's body over the two tables delta_k and cnt_k, where
// (state, count) need more than 31 bits; two independent loads per gram
// step, the next index depending on the first.
//
// Bound: one dependent gather of the packed k-gram table per k symbols,
// so load latency. The table (28 MB for the 1,000-keyword byte dictionary
// at k = 3) fits in the H100's 50 MB L2; the 10,000-keyword batch-scoring
// dictionary's k = 1 table (62 MB) does not. One thread per stream leaves
// most of the card's thread slots empty, so K3, K5 and K9 split every
// stream or column into P sub-streams (ac_stepped_part), each warmed up
// over the launch's warm_steps grams before its body, with P picked per
// launch from the kernel's occupancy and the SM count (ac_pick_split) or
// forced by the launch's split field:
// - K3 and K9's stream form: one thread per sub-stream, the P sub-streams
//   of a stream in consecutive lanes, reduced by warp shuffles;
// - K5 and K9's batch form: lanes over 32 consecutive columns, so that
//   each row's symbol loads coalesce, and the P sub-streams over P warps
//   of the block, reduced through shared memory; a block holds at least
//   four warps, and the launcher picks P above AC_COLS_SPLIT only where
//   the launch fits one wave (ac_launch_cols in ac_scan.cuh, whose blocks
//   K6 and K2's time-major form share).
// Every launch writes each column's total once; the raw LUT is read from
// shared memory where it has at most kLutSmem entries. K4 keeps one thread
// per stream: its emit is written in stream order.
#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;    // K3, K4, K9 stream form

template <typename Layout, typename Table, int K>
__global__ void __launch_bounds__(kThreads)
    stepped_lanes_kernel(AcScanArgs a, int32_t P, int32_t lut_n) {
  extern __shared__ int32_t smem[];
  ac_lut_to_smem(a, lut_n, smem);
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  ac_stepped_lanes<K, Layout>(a, Table::make(a), a.B, P, t & ~(int64_t)31,
                              threadIdx.x & 31);
}

template <typename T>
__global__ void stepped_emit_kernel(AcScanArgs a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) ac_stepped_emit_stream<T>(a, b);
}

template <typename Layout, typename Table, int K>
cudaError_t launch_lanes(const AcScanArgs& a, cudaStream_t st) {
  const auto kernel = stepped_lanes_kernel<Layout, Table, K>;
  const int32_t lut_n = ac_lut_entries(a);
  int64_t slots[AC_SPLITS];
  AC_TRY(ac_slots(kernel, kThreads, 4 * lut_n, &slots[0]));
  for (int i = 1; i < AC_SPLITS; ++i) slots[i] = slots[0];
  const int P = ac_launch_split(a, a.B, slots, AC_MAX_SPLIT);
  if (P == 0) return cudaErrorInvalidValue;
  const int64_t grid = ((int64_t)a.B * P + kThreads - 1) / kThreads;
  if (grid == 0) return cudaSuccess;
  kernel<<<(unsigned)grid, kThreads, 4 * lut_n, st>>>(a, P, lut_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ac_stepped_count(const AcScanArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    AC_WITH_K(a->k, return (int)launch_lanes<AcStreamLayout<uint8_t>,
                                             AcPackedTable, K>(*a, st));
  AC_WITH_K(a->k, return (int)launch_lanes<AcStreamLayout<int32_t>,
                                           AcPackedTable, K>(*a, st));
  return 0;
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
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    AC_WITH_K(a->k, return (int)ac_launch_cols<AcBatchLayout<uint8_t>,
                                            AcPackedTable, K, false>(*a, st));
  AC_WITH_K(a->k, return (int)ac_launch_cols<AcBatchLayout<int32_t>,
                                          AcPackedTable, K, false>(*a, st));
  return 0;
}

extern "C" int ac_stepped_count_2t(const AcScanArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a->layout == 1)
    AC_WITH_K(a->k, return (int)ac_launch_cols<AcBatchLayout<int32_t>,
                                            AcTwoTables, K, false>(*a, st));
  if (a->ext_u8)
    AC_WITH_K(a->k, return (int)launch_lanes<AcStreamLayout<uint8_t>,
                                             AcTwoTables, K>(*a, st));
  AC_WITH_K(a->k, return (int)launch_lanes<AcStreamLayout<int32_t>,
                                           AcTwoTables, K>(*a, st));
  return 0;
}

extern "C" int ac_last_split(void) { return g_ac_last_split; }

extern "C" int ac_stepped_split(int64_t n_cols, int64_t n_body,
                                int64_t halo_steps, int64_t warm_steps,
                                const int64_t* slots, int wide_split) {
  return ac_pick_split(n_cols, n_body, halo_steps, warm_steps, slots,
                       wide_split);
}
