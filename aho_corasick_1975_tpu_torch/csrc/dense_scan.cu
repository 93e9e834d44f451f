// K1 dense count, K2 dense states (stream, one-thread and time-major forms)
// and K6 dense count_many for sm_90a.
//
// K1 replaces ops/scan_pallas.py:make_pallas_blocked_count (the JAX
// package's only Pallas kernel) and ops/scan_xla.py:make_blocked_count_stream
// / _raw. It returns per-stream int32 totals, which the host sums in int64;
// the Pallas kernel's single int32 sum could wrap. K2 replaces
// ops/scan_xla.py:make_blocked_scan_stream / _raw (stream form),
// make_sequential_scan (one thread) and make_blocked_scan (time-major).
// K6 replaces ops/scan_xla.py:_count_many_body / make_blocked_count_many
// (split_docs_layout folded into the addressing): K1's recurrence over the
// [L, B] batch, the count_many path without a packed table.
//
// Bound: a dependent chain of one table gather per symbol per thread
// (dflat; nb_out's gather hangs off it), so load latency, and K2's states,
// 4 bytes a symbol, the one output that is not small. Every kernel here
// runs K3's sub-stream walk at k = 1 over the 1-char tables
// (AcDenseTable): each stream or column split into P sub-streams, each
// warmed up over warm_steps symbols from the root, the LUT in shared
// memory, and the tables staged on the SM where they fit, else read
// through the read-only path.
// - K1 and K2's stream form (ac_dense_plan): one thread a sub-stream,
//   the stream's symbols loaded a group ahead as aligned 16-byte vectors
//   (AcVecGroup). K1's P sub-streams of a stream sit in consecutive lanes,
//   reduced by warp shuffles (ac_dense_count_kernel, which K7 dense also
//   runs over its windows); K2 stages each thread's states in shared
//   memory and writes each aligned run of 8 as two 16-byte stores, whole
//   sectors (AcStatesEmit).
// - K2's one-chain form (scan_states_sequential, the conformance oracle
//   of the split scans, and any stream launch of B = 1 kept at P = 1): one
//   chain from the root, which no warm-up argument touches. One block: a
//   thread walks a chunk of letter ids in shared memory while the other
//   warps translate the next chunk and write the last one's states out
//   (ac_seq_*), so the chain is the table gather alone, the tables on the
//   SM where they fit.
// - K6 and K2's time-major form: K5's batch blocks (ac_launch_cols), a
//   warp's lanes over 32 neighbouring columns so that each row's symbol
//   loads (and K2's state stores, one 128-byte row a warp) coalesce, each
//   column's P sub-streams over P warps, K6's totals reduced through
//   shared memory. Their tables stay in device memory, read through the
//   read-only path: copied onto the SM (one 512-thread block an SM) they
//   took 21% (K6) and 10% (K2) longer at the slice's step_k=1 shapes, and
//   at config 3 (62 MB) they do not fit (PERF.md).
#include <cuda_runtime.h>

#include "ac_scan.cuh"

namespace {

// K2's stream form: the launch's B*P sub-streams over the grid's loop,
// each thread staging its states in kStateStage words of shared memory
// from stage + threadIdx.x on, blockDim.x apart.
template <typename Layout, typename Table>
__device__ __forceinline__ void dense_states_subs(const AcScanArgs& a,
                                                  const Table& table,
                                                  int32_t P, int32_t* stage) {
  const int64_t n = (int64_t)a.B * P;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += stride)
    ac_dense_states_sub<Layout>(a, table, g, P, stage + threadIdx.x,
                                blockDim.x);
}

template <typename Layout, bool OnSm>
__global__ void __launch_bounds__(OnSm ? kDenseSmThreads : kDenseThreads)
    dense_states_kernel(AcScanArgs a, int32_t P, int32_t lut_n,
                        int32_t tab_words) {
  extern __shared__ int32_t smem[];
  ac_lut_to_smem(a, lut_n, smem);
  int32_t* stage = smem + lut_n + tab_words;
  if constexpr (OnSm)
    dense_states_subs<Layout>(a, ac_dense_sm_table<false>(a, smem + lut_n),
                              P, stage);
  else
    dense_states_subs<Layout>(a, AcDenseTable<int32_t, false>::make(a), P,
                              stage);
}

// K2's one-chain launch: warp 0's first thread walks chunk i (ids and
// states double-buffered in shared memory after the LUT and the tables)
// while the other warps load chunk i + 1 and store chunk i - 1; the block
// meets at a barrier between chunks.
template <typename T, typename Table>
__device__ __forceinline__ void dense_seq_chunks(const AcScanArgs& a,
                                                 const Table& table,
                                                 int32_t* ids) {
  constexpr int C = kSeqChunk;
  int32_t* st = ids + 2 * C;
  const AcSyms<T> sym = ac_syms<T>(a, 0);
  const int64_t rows = (int64_t)a.halo + a.L;
  const int64_t n_chunks = (rows + C - 1) / C;
  const auto len = [&](int64_t i) {
    return (int)(rows - i * C < C ? rows - i * C : C);
  };
  const int tid = (int)threadIdx.x - 32, nth = (int)blockDim.x - 32;
  if (n_chunks > 0) ac_seq_load(sym, 0, len(0), ids, threadIdx.x, blockDim.x);
  __syncthreads();
  int32_t s = 0;
  for (int64_t i = 0; i <= n_chunks; ++i) {
    const int b = (int)(i & 1);
    if (threadIdx.x == 0 && i < n_chunks) {
      s = ac_seq_walk(table, a.V, ids + b * C, st + b * C, len(i), s);
    } else if (tid >= 0) {
      if (i + 1 < n_chunks)
        ac_seq_load(sym, (i + 1) * C, len(i + 1), ids + (b ^ 1) * C, tid,
                    nth);
      if (i >= 1)
        ac_seq_store(a, (i - 1) * C, len(i - 1), st + (b ^ 1) * C, tid, nth);
    }
    __syncthreads();
  }
}

template <typename T, bool OnSm>
__global__ void __launch_bounds__(kDenseSmThreads)
    dense_seq_kernel(AcScanArgs a, int32_t lut_n, int32_t tab_words) {
  extern __shared__ int32_t smem[];
  ac_lut_to_smem(a, lut_n, smem);
  int32_t* ids = smem + lut_n + tab_words;
  if constexpr (OnSm)
    dense_seq_chunks<T>(a, ac_dense_sm_table<false>(a, smem + lut_n), ids);
  else
    dense_seq_chunks<T>(a, AcDenseTable<int32_t, false>::make(a), ids);
}

// One block beside the LUT and 4 * kSeqChunk words of ids and states, the
// tables on the SM where they fit there too.
template <typename T>
cudaError_t dense_seq(const AcScanArgs& args, cudaStream_t st) {
  const AcScanArgs a = ac_dense_args(args);
  const int32_t lut_n = ac_lut_entries(a);
  const int64_t beside = 4 * ((int64_t)lut_n + 4 * kSeqChunk);
  int64_t tab = 0;
  AC_TRY(ac_dense_tab(a, beside, &tab));
  const auto kernel =
      tab > 0 ? dense_seq_kernel<T, true> : dense_seq_kernel<T, false>;
  int64_t smem = 0;
  AcOccupancy occ;
  AC_TRY(ac_dense_block((const void*)kernel, kDenseSmThreads, beside + tab,
                        false, &smem, &occ));
  kernel<<<1, kDenseSmThreads, smem, st>>>(a, lut_n, (int32_t)(tab / 4));
  return cudaGetLastError();
}

template <typename T>
int dense_count(const AcScanArgs* a, void* stream) {
  return (int)ac_dense_launch(
      *a, ac_dense_count_kernel<AcStreamLayout<T>, true>,
      ac_dense_count_kernel<AcStreamLayout<T>, false>, AcDenseStage{0, 0, 0},
      (cudaStream_t)stream);
}

// K2's stream form; a launch of one stream at P = 1 is the one-chain
// kernel's.
template <typename T>
int dense_states(const AcScanArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  AcDensePlan p;
  AC_TRY(ac_dense_plan(*a, dense_states_kernel<AcStreamLayout<T>, true>,
                       dense_states_kernel<AcStreamLayout<T>, false>,
                       AcDenseStage{kStateStage, kStateStage, kStateStage},
                       &p));
  return (int)(a->B == 1 && p.P == 1 ? dense_seq<T>(*a, st)
                                     : ac_dense_run(p, st));
}

}  // namespace

extern "C" int ac_dense_count(const AcScanArgs* a, void* stream) {
  return a->ext_u8 ? dense_count<uint8_t>(a, stream)
                   : dense_count<int32_t>(a, stream);
}

extern "C" int ac_dense_states(const AcScanArgs* a, void* stream) {
  return a->ext_u8 ? dense_states<uint8_t>(a, stream)
                   : dense_states<int32_t>(a, stream);
}

extern "C" int ac_dense_count_many(const AcScanArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const AcScanArgs d = ac_dense_args(*a);
  return (int)(d.ext_u8 ? ac_launch_cols<AcBatchLayout<uint8_t>,
                                         AcDenseTable<int32_t>, 1, false>(d, st)
                        : ac_launch_cols<AcBatchLayout<int32_t>,
                                         AcDenseTable<int32_t>, 1, false>(d,
                                                                          st));
}

// K2 over a time-major [L, n_docs] batch of letter ids
// (ops/scan_xla.py:make_blocked_scan): the n_docs columns from the root.
extern "C" int ac_dense_states_tm(const AcScanArgs* a, void* stream) {
  return (int)ac_launch_cols<AcBatchLayout<int32_t>,
                             AcDenseTable<int32_t, false>, 1, true>(
      ac_dense_args(*a), (cudaStream_t)stream);
}

extern "C" const char* ac_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
