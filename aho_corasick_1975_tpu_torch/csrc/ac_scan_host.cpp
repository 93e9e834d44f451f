// Host build of the per-thread scans in ac_scan.cuh, with the same C entry
// points as the CUDA kernels: each loops over the streams (or batch
// columns, or windows) one by one, and the MXU kernels over their warps,
// each warp's 32 lanes in turn with the tensor-core instruction and the
// warp's votes and shuffles emulated.
// Built with g++ by the CPU tests, so that the logic the H100 kernels run
// is tested where there is no GPU; the scanner never loads it.
#include "ac_scan.cuh"

namespace {

template <void (*U8)(const AcScanArgs&, int64_t),
          void (*I32)(const AcScanArgs&, int64_t)>
int run(const AcScanArgs* a, int64_t n) {
  for (int64_t b = 0; b < n; ++b) (a->ext_u8 ? U8 : I32)(*a, b);
  return 0;
}

template <void (*U8)(const AcScanArgs&, int64_t),
          void (*I32)(const AcScanArgs&, int64_t)>
int run(const AcScanArgs* a) {
  return run<U8, I32>(a, a->B);
}

// The warps of R rows each over the columns [col0, end).
template <int R, typename Layout>
int mxu_warps(const AcScanArgs& a, int64_t col0, int64_t end) {
  for (int64_t c = col0; c < end; c += R)
    ac_mxu_warp<R, Layout>(a, a.planes_t, 0, c);
  return 0;
}

}  // namespace

extern "C" {

int ac_dense_count(const AcScanArgs* a, void*) {
  return run<ac_dense_count_stream<uint8_t>, ac_dense_count_stream<int32_t>>(a);
}

int ac_dense_states(const AcScanArgs* a, void*) {
  return run<ac_dense_states_stream<uint8_t>, ac_dense_states_stream<int32_t>>(a);
}

int ac_stepped_count(const AcScanArgs* a, void*) {
  return run<ac_stepped_count_stream<uint8_t>, ac_stepped_count_stream<int32_t>>(a);
}

int ac_stepped_emit(const AcScanArgs* a, void*) {
  return run<ac_stepped_emit_stream<uint8_t>, ac_stepped_emit_stream<int32_t>>(a);
}

int ac_dense_states_tm(const AcScanArgs* a, void*) {
  return run<ac_dense_states_tm_column<uint8_t>,
             ac_dense_states_tm_column<int32_t>>(a, a->n_docs);
}

int ac_sparse_count(const AcScanArgs* a, void*) {
  return run<ac_sparse_count_column, ac_sparse_count_column>(a);
}

int ac_sparse_count_stepped(const AcScanArgs* a, void*) {
  return run<ac_sparse_count_stepped_column,
             ac_sparse_count_stepped_column>(a);
}

int ac_dense_hits(const AcScanArgs* a, void*) {
  return run<ac_dense_hits_stream<uint8_t>, ac_dense_hits_stream<int32_t>>(a);
}

int ac_window_hits(const AcScanArgs* a, void*) {
  return run<ac_window_hits_column, ac_window_hits_column>(a);
}

int ac_dense_count_many(const AcScanArgs* a, void*) {
  return run<ac_dense_count_many_column<uint8_t>,
             ac_dense_count_many_column<int32_t>>(a);
}

int ac_stepped_count_many(const AcScanArgs* a, void*) {
  return run<ac_stepped_count_many_column<uint8_t>,
             ac_stepped_count_many_column<int32_t>>(a);
}

int ac_stepped_count_2t(const AcScanArgs* a, void*) {
  if (a->layout == 1)
    return run<ac_stepped_count_2t_column, ac_stepped_count_2t_column>(a);
  return run<ac_stepped_count_2t_stream<uint8_t>,
             ac_stepped_count_2t_stream<int32_t>>(a);
}

int ac_mxu_count(const AcScanArgs* a, void*) {
  constexpr int R = AC_K10_ROWS;
  if (a->layout == 2) return mxu_warps<R, AcWinLayout>(*a, 0, a->B);
  if (a->layout == 1 && a->ext_u8)
    return mxu_warps<R, AcBatchLayout<uint8_t>>(*a, 0, a->B);
  if (a->layout == 1)
    return mxu_warps<R, AcBatchLayout<int32_t>>(*a, 0, a->B);
  if (a->ext_u8) return mxu_warps<R, AcStreamLayout<uint8_t>>(*a, 0, a->B);
  return mxu_warps<R, AcStreamLayout<int32_t>>(*a, 0, a->B);
}

int ac_hybrid_count(const AcScanArgs* a, void*) {
  constexpr int R = AC_K11_ROWS;
  run<ac_stepped_count_stream<uint8_t>, ac_stepped_count_stream<int32_t>>(
      a, a->B1);
  if (a->ext_u8)
    return mxu_warps<R, AcStreamLayout<uint8_t>>(*a, a->B1, a->B);
  return mxu_warps<R, AcStreamLayout<int32_t>>(*a, a->B1, a->B);
}

int ac_assoc_scan(const AcScanArgs* a, void*) {
  for (int64_t c = 0; c < a->B; ++c)
    for (int32_t s = 0; s < a->n_states; ++s)
      ac_assoc_compose_state(*a, a->table, c, s);
  ac_assoc_chain(*a);
  for (int64_t c = 0; c < a->B; ++c) ac_assoc_states_chunk(*a, a->table, c);
  return 0;
}

const char* ac_error_string(int) { return "host build"; }

}  // extern "C"
