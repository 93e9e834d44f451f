// K7 sparse window counts and K8 1-char bounded hits for sm_90a. K7
// dense: K1's lanes (ac_dense_count_kernel) over the windows, each window
// P sub-streams in consecutive lanes, reduced by warp shuffles. K7
// stepped: one thread per live-block window, running the per-thread scan
// of ac_scan.cuh. K8: each stream (stream form) or window (window form)
// split into P sub-streams, one thread each (ac_dense_hits_sub).
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
// pow2(n_live*L_blk) on the prefilter's auto path), K8 runs twice at one
// P (ac_dense_hits_split / ac_window_hits_split give it): pass 1 counts
// each sub-stream's hit positions, the wrapper takes their exclusive
// prefix sum (one 8-byte sync gives the total), and pass 2 re-runs the
// sub-streams and writes each hit at its sub-stream's offset, so the
// output is exactly 8 bytes per matching position. Its sub-streams are
// K1's: warmed up over warm_steps symbols from the root, symbols loaded a
// group ahead, the LUT and, where they fit, the 1-char tables on the SM
// (ac_dense_plan); there pass 2 stages its hits in shared memory and
// writes whole 32-byte sectors (AcHitsEmit).
//
// Bound: a dependent chain of gathers per symbol (dflat, then nb_out; one
// packed gather per k symbols for K7 stepped), so load latency, until
// enough chains run: K7 dense's windows (the hunt's 65,536 of 136 rows)
// are 35.7 MB of ids, 0.011 ms at 3.35 TB/s. K7 dense therefore takes
// the tables onto the SM (a few KB at the hunt, as uint16 rows), its
// symbols off the chain a group ahead, and sub-streams where the windows
// do not fill the card. Its index-list form reads each window's
// contiguous rows as aligned 16-byte vectors (AcWinRowsLayout); its
// elided windows are time-major, so neighbouring lanes read neighbouring
// windows of a row and a warp's loads coalesce: K1's lanes put a window's
// P sub-streams in consecutive lanes (a row's 32/P neighbours, whole
// sectors up to P = 8).
#include <cuda_runtime.h>

#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void sparse_count_stepped_kernel(AcScanArgs a) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < a.B) ac_sparse_count_stepped_column(a, c);
}

// K8: the launch's B*P sub-streams over the grid's loop, pass 2 (Write)
// staging each thread's hits in shared memory from stage on, where stage
// is not null (AcHitsEmit).
template <bool Write, typename Layout, typename Table>
__device__ __forceinline__ void hits_subs(const AcScanArgs& a,
                                          const Table& table, int32_t P,
                                          int32_t* stage) {
  const int64_t n = (int64_t)a.B * P;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += stride)
    ac_dense_hits_sub<Write, Layout>(a, table, g, P,
                                     stage ? stage + threadIdx.x : nullptr,
                                     blockDim.x);
}

template <typename Layout, bool OnSm, bool Write>
__global__ void __launch_bounds__(OnSm ? kDenseSmThreads : kDenseThreads)
    hits_kernel(AcScanArgs a, int32_t P, int32_t lut_n, int32_t tab_words) {
  extern __shared__ int32_t smem[];
  ac_lut_to_smem(a, lut_n, smem);
  if constexpr (OnSm)
    hits_subs<Write, Layout>(a, ac_dense_sm_table(a, smem + lut_n), P,
                             Write ? smem + lut_n + tab_words : nullptr);
  else
    hits_subs<Write, Layout>(a, AcDenseTable<int32_t>::make(a), P, nullptr);
}

// Launch K8's pass over Layout (pass 2 where hit_pos is set), or with
// pick non-null only write its P. Both passes reserve room for pass 2's
// staged hits, so that they stage the tables alike.
template <typename Layout, bool Write>
int hits_pass(const AcScanArgs* a, void* stream, int* pick) {
  AcDensePlan p;
  AC_TRY(ac_dense_plan(*a, hits_kernel<Layout, true, Write>,
                       hits_kernel<Layout, false, Write>,
                       AcDenseStage{2 * kHitStage, Write ? 2 * kHitStage : 0,
                                    0},
                       &p));
  if (pick != nullptr) {
    *pick = p.P;
    return 0;
  }
  return (int)ac_dense_run(p, (cudaStream_t)stream);
}

template <typename Layout>
int hits(const AcScanArgs* a, void* stream, int* pick) {
  return a->hit_pos ? hits_pass<Layout, true>(a, stream, pick)
                    : hits_pass<Layout, false>(a, stream, pick);
}

int stream_hits(const AcScanArgs* a, void* stream, int* pick) {
  return a->ext_u8 ? hits<AcStreamLayout<uint8_t>>(a, stream, pick)
                   : hits<AcStreamLayout<int32_t>>(a, stream, pick);
}

// K7 dense over Layout's windows on K1's lanes, the tables on the SM where
// they fit, unpadded (as many blocks an SM as fit; one an SM ran slower at
// the hunt's few-KB tables), or with pick non-null only its P.
template <typename Layout>
int count_lanes(const AcScanArgs* a, void* stream, int* pick) {
  AcDensePlan p;
  AC_TRY(ac_dense_plan(*a, ac_dense_count_kernel<Layout, true>,
                       ac_dense_count_kernel<Layout, false>,
                       AcDenseStage{0, 0, 0, false}, &p));
  if (pick != nullptr) {
    *pick = p.P;
    return 0;
  }
  return (int)ac_dense_run(p, (cudaStream_t)stream);
}

// K7 dense: the index list's windows as contiguous rows, the elided ones
// strided.
int sparse_count(const AcScanArgs* a, void* stream, int* pick) {
  return a->gather ? count_lanes<AcWinRowsLayout>(a, stream, pick)
                   : count_lanes<AcWinLayout>(a, stream, pick);
}

}  // namespace

extern "C" int ac_sparse_count(const AcScanArgs* a, void* stream) {
  return sparse_count(a, stream, nullptr);
}

extern "C" int ac_sparse_count_split(const AcScanArgs* a, int* P) {
  return sparse_count(a, nullptr, P);
}

extern "C" int ac_sparse_count_stepped(const AcScanArgs* a, void* stream) {
  const dim3 grid((a->B + kThreads - 1) / kThreads);
  sparse_count_stepped_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}

extern "C" int ac_dense_hits(const AcScanArgs* a, void* stream) {
  return stream_hits(a, stream, nullptr);
}

extern "C" int ac_dense_hits_split(const AcScanArgs* a, int* P) {
  return stream_hits(a, nullptr, P);
}

extern "C" int ac_window_hits(const AcScanArgs* a, void* stream) {
  return hits<AcWinLayout>(a, stream, nullptr);
}

extern "C" int ac_window_hits_split(const AcScanArgs* a, int* P) {
  return hits<AcWinLayout>(a, nullptr, P);
}
