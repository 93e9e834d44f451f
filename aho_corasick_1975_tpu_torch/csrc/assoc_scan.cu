// K12, the associative-scan formulation for sm_90a: states[T] after every
// symbol from the root, by composition of the symbols' transition
// functions f_c = delta[:, c] (a simultaneous-DFA scan).
//
// Replaces ops/scan_assoc.py:make_assoc_scan, which materialises [T, S]
// function vectors and composes them with lax.associative_scan in log T
// steps. The kernel keeps no [T, S] array: it cuts the ids into B chunks
// of L and the chunks into tiles of G, and runs three launches on one
// stream (the per-thread bodies are ac_scan.cuh's ac_assoc_*):
//   1. compose: each block stages a group of chunks' ids on the SM with
//      16-byte loads, and one thread per (chunk, state) pair computes the
//      chunk's function F_c[s]: B*S threads, each a chain of L lookups of
//      delta, whose rows sit on the SM as uint16 where they fit (the
//      opt-in shared memory past 48 KB), else go through the read-only
//      path; blocks loop over groups, one wave of them;
//   2. tiles: one block per tile composes its G chunk functions at every
//      state, over the tile's rows of F staged on the SM, into H_i;
//   3. states: one block per tile, a thread per chunk: thread 0 applies
//      H_0 .. H_{i-1} to the root (the tile's start), each thread then its
//      tile's functions before its chunk (its start), and re-runs its chunk
//      from there as K2's stream walk (ids as 16-byte vectors a group
//      ahead), writing whole 32-byte sectors of states staged on the SM.
// No chain is longer than L, G or n_tiles steps, and those of phases 2-3
// read the SM where the functions fit (G and n_tiles about sqrt(B):
// ops/scan_assoc.py:tile_for).
//
// Bound: T*S table lookups by design (the blocked scan, K2, does T), at
// most 32 a clock per SM from shared memory: at T = 2^20 and S = 26, 27.3
// M lookups, 3-4 us over 132 SMs. Bytes: ids in and states out, 8*T (2.5
// us at 2^20), and the functions (B + n_tiles)*S*4 written and read.
#include <cuda_runtime.h>

#include "ac_scan.cuh"

namespace {

constexpr int kComposeThreads = 256;
constexpr int kTileThreads = 256;
// Bytes of F and H rows a block of phases 2-3 stages on the SM at most;
// past it they are read in place (L2).
constexpr int64_t kFnSmem = 96 * 1024;

// n words from src to dst (shared memory) by the block, four a load where
// both are 16-byte aligned.
__device__ void stage_words(int32_t* dst, const int32_t* src, int64_t n) {
  const int64_t quads = (((uintptr_t)src | (uintptr_t)dst) & 15) ? 0 : n / 4;
  for (int64_t i = threadIdx.x; i < quads; i += blockDim.x)
    ((int4*)dst)[i] = __ldg((const int4*)src + i);
  for (int64_t i = 4 * quads + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = __ldg(src + i);
}

// Phase 1: shared memory holds cpb chunks of ids, then, OnSm, delta's
// rows.
template <bool OnSm>
__global__ void __launch_bounds__(kComposeThreads)
    assoc_compose_kernel(AcScanArgs a, int32_t cpb) {
  extern __shared__ int32_t smem[];
  int32_t* ids = smem;
  const int32_t S = a.n_states;
  const auto table = [&] {
    if constexpr (OnSm)
      return ac_dense_sm_table<false>(a, smem + (int64_t)cpb * a.L);
    else
      return AcDenseTable<int32_t, false>::make(a);
  }();
  const int64_t groups = (a.B + cpb - 1) / cpb;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t c0 = g * cpb;
    const int64_t n_c = c0 + cpb < a.B ? cpb : a.B - c0;
    const int64_t t0 = c0 * a.L;
    const int64_t t1 = t0 + n_c * a.L < a.doc_len ? t0 + n_c * a.L
                                                  : a.doc_len;
    stage_words(ids, (const int32_t*)a.ext + t0, t1 - t0);
    __syncthreads();
    for (int64_t q = threadIdx.x; q < n_c * S; q += blockDim.x) {
      const int64_t cl = q / S;
      ac_assoc_compose(a, table, ids + cl * a.L, c0 + cl, (int32_t)(q % S));
    }
    __syncthreads();
  }
}

// Phase 2: tile blockIdx.x's rows of F on the SM where fn_on_sm.
__global__ void __launch_bounds__(kTileThreads)
    assoc_tiles_kernel(AcScanArgs a, int32_t fn_on_sm) {
  extern __shared__ int32_t smem[];
  const int64_t i = blockIdx.x;
  const int32_t S = a.n_states;
  const int32_t* fns = a.compose + i * a.tile * S;
  if (fn_on_sm) {
    stage_words(smem, fns, ac_assoc_tile_len(a, i) * S);
    __syncthreads();
    fns = smem;
  }
  for (int32_t s = threadIdx.x; s < S; s += blockDim.x)
    ac_assoc_tile(a, fns, i, s);
}

// Phase 3: shared memory holds, where fn_on_sm, H_0 .. H_{i-1} and the
// tile's rows of F (n_tiles + G rows), then kStateStage words a thread,
// then, OnSm, delta's rows. A block holds at most kAssocMaxTile threads.
template <bool OnSm>
__global__ void __launch_bounds__(kAssocMaxTile)
    assoc_states_kernel(AcScanArgs a, int32_t fn_on_sm, int64_t fn_words) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t tile_start;
  const int64_t i = blockIdx.x, c0 = i * a.tile;
  const int32_t S = a.n_states;
  const int32_t* tiles = a.compose + a.B * S;
  const int32_t* fns = a.compose + c0 * S;
  int32_t* stage = smem + (fn_on_sm ? fn_words : 0);
  if (fn_on_sm) {
    stage_words(smem, tiles, i * S);
    stage_words(smem + i * S, fns, ac_assoc_tile_len(a, i) * S);
    tiles = smem;
    fns = smem + i * S;
  }
  const auto table = [&] {
    if constexpr (OnSm)
      return ac_dense_sm_table<false>(a, stage + kStateStage * blockDim.x);
    else
      return AcDenseTable<int32_t, false>::make(a);
  }();
  __syncthreads();
  if (threadIdx.x == 0) tile_start = ac_assoc_apply(tiles, S, i, 0);
  __syncthreads();
  const int r = threadIdx.x;
  if (r < ac_assoc_tile_len(a, i))
    ac_assoc_states(a, table, c0 + r, ac_assoc_apply(fns, S, r, tile_start),
                    stage + threadIdx.x, blockDim.x);
}

// The launch of a kernel of `threads` with `bytes` of dynamic shared
// memory (the opt-in past 48 KB): its blocks an SM, at least one.
template <typename Kernel>
cudaError_t plan(Kernel kernel, int threads, int64_t bytes,
                 AcOccupancy* occ) {
  int64_t smem = 0;
  return ac_dense_block((const void*)kernel, threads, bytes, false, &smem,
                        occ);
}

template <bool OnSm>
cudaError_t compose(const AcScanArgs& a, int32_t cpb, int64_t bytes,
                    cudaStream_t st) {
  const auto kernel = assoc_compose_kernel<OnSm>;
  AcOccupancy occ;
  AC_TRY(plan(kernel, kComposeThreads, bytes, &occ));
  const int64_t groups = (a.B + cpb - 1) / cpb;
  const int64_t wave = (int64_t)occ.sms * occ.blocks;
  kernel<<<(unsigned)(groups < wave ? groups : wave), kComposeThreads, bytes,
           st>>>(a, cpb);
  return cudaGetLastError();
}

template <bool OnSm>
cudaError_t states(const AcScanArgs& a, int64_t n_tiles, int threads,
                   int32_t fn_on_sm, int64_t fn_words, int64_t bytes,
                   cudaStream_t st) {
  const auto kernel = assoc_states_kernel<OnSm>;
  AcOccupancy occ;
  AC_TRY(plan(kernel, threads, bytes, &occ));
  kernel<<<(unsigned)n_tiles, threads, bytes, st>>>(a, fn_on_sm, fn_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ac_assoc_scan(const AcScanArgs* args, void* stream) {
  const AcScanArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (!ac_assoc_valid(a)) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const int64_t S = a.n_states, n_tiles = (a.B + a.tile - 1) / a.tile;

  // 1. compose: as many chunks a block as give its threads pairs, and
  // whose ids fit kAssocMaxChunk words
  int64_t cpb = S >= kComposeThreads ? 1 : kComposeThreads / S;
  if (cpb * a.L > kAssocMaxChunk) cpb = kAssocMaxChunk / a.L;
  if (cpb > a.B) cpb = a.B;
  const int64_t ids_bytes = 4 * cpb * a.L;
  int64_t tab = 0;
  AC_TRY(ac_dense_tab(a, ids_bytes, &tab));
  AC_TRY(tab > 0 ? compose<true>(a, (int32_t)cpb, ids_bytes + tab, st)
                 : compose<false>(a, (int32_t)cpb, ids_bytes, st));

  // 2. tiles
  const int32_t tile_on_sm = 4 * a.tile * S <= kFnSmem;
  const int64_t tile_bytes = tile_on_sm ? 4 * a.tile * S : 0;
  AcOccupancy occ;
  AC_TRY(plan(assoc_tiles_kernel, kTileThreads, tile_bytes, &occ));
  assoc_tiles_kernel<<<(unsigned)n_tiles, kTileThreads, tile_bytes, st>>>(
      a, tile_on_sm);
  AC_TRY(cudaGetLastError());

  // 3. states: a thread a chunk of the tile, whole warps
  const int threads = (a.tile + 31) / 32 * 32;
  const int64_t fn_words = (n_tiles + a.tile) * S;
  const int32_t fn_on_sm = 4 * fn_words <= kFnSmem;
  const int64_t beside =
      4 * ((fn_on_sm ? fn_words : 0) + (int64_t)kStateStage * threads);
  AC_TRY(ac_dense_tab(a, beside, &tab));
  return (int)(tab > 0 ? states<true>(a, n_tiles, threads, fn_on_sm,
                                      fn_words, beside + tab, st)
                       : states<false>(a, n_tiles, threads, fn_on_sm,
                                       fn_words, beside, st));
}
