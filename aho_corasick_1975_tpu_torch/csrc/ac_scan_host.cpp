// Host build of the per-thread scans in ac_scan.cuh, with the same C entry
// points as the CUDA kernels: each loops over the streams (or batch
// columns) one by one. Built
// with g++ by the CPU tests, so that the logic the H100 kernels run is
// tested where there is no GPU; the scanner never loads it.
#include "ac_scan.cuh"

namespace {

template <void (*U8)(const AcScanArgs&, int64_t),
          void (*I32)(const AcScanArgs&, int64_t)>
int run(const AcScanArgs* a) {
  for (int64_t b = 0; b < a->B; ++b) (a->ext_u8 ? U8 : I32)(*a, b);
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

int ac_dense_count_many(const AcScanArgs* a, void*) {
  return run<ac_dense_count_many_column<uint8_t>,
             ac_dense_count_many_column<int32_t>>(a);
}

int ac_stepped_count_many(const AcScanArgs* a, void*) {
  return run<ac_stepped_count_many_column<uint8_t>,
             ac_stepped_count_many_column<int32_t>>(a);
}

const char* ac_error_string(int) { return "host build"; }

}  // extern "C"
