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
// shared memory where it has at most kLutSmem entries.
//
// K4 takes K3's launch: P sub-streams a stream in consecutive lanes, each
// warmed up over ceil(max_depth / k) grams (one symbol more than K3's: it
// also writes the state before its first body gram), writing the word of
// each of its body grams at the gram's fixed slot of the stream-major
// [B, L/k] emit, so the sub-streams need no offsets and one pass. A warp's
// lanes write 32 separate runs, so each thread stages kStateStage words in
// shared memory and writes whole 32-byte sectors (AcStatesEmit); n_hits
// and n_live reduce by warp shuffles as K3's totals do. Bytes: 4 per gram
// out (92 MB at 16,384 streams of 1,408 grams) beside a byte a symbol in.
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

// K4: the LUT, then each thread's kStateStage staged words, interleaved.
template <typename Layout, int K>
__global__ void __launch_bounds__(kThreads)
    stepped_emit_kernel(AcScanArgs a, int32_t P, int32_t lut_n) {
  extern __shared__ int32_t smem[];
  ac_lut_to_smem(a, lut_n, smem);
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  ac_stepped_emit_lanes<K, Layout>(a, ac_packed(a), P, t & ~(int64_t)31,
                                   threadIdx.x & 31,
                                   smem + lut_n + threadIdx.x, kThreads);
}

// One thread a sub-stream over a's B streams, with the LUT and
// stage_words words a thread in shared memory; P from the kernel's own
// occupancy (ac_launch_split) or forced.
template <typename Kernel>
cudaError_t launch_lanes_of(Kernel kernel, const AcScanArgs& a,
                            int stage_words, cudaStream_t st) {
  const int32_t lut_n = ac_lut_entries(a);
  const int64_t smem = 4 * ((int64_t)lut_n + (int64_t)stage_words * kThreads);
  int64_t slots[AC_SPLITS];
  AC_TRY(ac_slots(kernel, kThreads, smem, &slots[0]));
  for (int i = 1; i < AC_SPLITS; ++i) slots[i] = slots[0];
  const int P = ac_launch_split(a, a.B, slots, AC_MAX_SPLIT);
  if (P == 0) return cudaErrorInvalidValue;
  const int64_t grid = ((int64_t)a.B * P + kThreads - 1) / kThreads;
  if (grid == 0) return cudaSuccess;
  kernel<<<(unsigned)grid, kThreads, smem, st>>>(a, P, lut_n);
  return cudaGetLastError();
}

template <typename Layout, typename Table, int K>
cudaError_t launch_lanes(const AcScanArgs& a, cudaStream_t st) {
  return launch_lanes_of(stepped_lanes_kernel<Layout, Table, K>, a, 0, st);
}

template <typename Layout, int K>
cudaError_t launch_emit(const AcScanArgs& a, cudaStream_t st) {
  return launch_lanes_of(stepped_emit_kernel<Layout, K>, a, kStateStage,
                         st);
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
  cudaStream_t st = (cudaStream_t)stream;
  if (a->ext_u8)
    AC_WITH_K(a->k, return (int)launch_emit<AcStreamLayout<uint8_t>, K>(
                        *a, st));
  AC_WITH_K(a->k, return (int)launch_emit<AcStreamLayout<int32_t>, K>(
                      *a, st));
  return 0;
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

extern "C" int64_t ac_last_dense_table(void) { return g_ac_last_dense_table; }

extern "C" int ac_stepped_split(int64_t n_cols, int64_t n_body,
                                int64_t halo_steps, int64_t warm_steps,
                                const int64_t* slots, int wide_split) {
  return ac_pick_split(n_cols, n_body, halo_steps, warm_steps, slots,
                       wide_split);
}
