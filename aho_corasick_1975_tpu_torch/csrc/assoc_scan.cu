// K12, the associative-scan formulation for sm_90a: states[T] after every
// symbol from the root, by composition of the symbols' transition
// functions f_c = delta[:, c], chunk by chunk (a simultaneous-DFA scan).
//
// Replaces ops/scan_assoc.py:make_assoc_scan, which materialises [T, S]
// function vectors and composes them with lax.associative_scan in log T
// steps. The kernel keeps no [T, S] array: it cuts the stream into B
// chunks of L symbols and runs three launches on one stream,
//   1. compose: one block per chunk, a thread per state s, computes the
//      chunk's composed function F_c[s] (the chunk run from s);
//   2. chain: one thread walks start[c+1] = F_c[start[c]] from the root;
//   3. states: a thread per chunk re-runs its chunk from start[c] and
//      writes the states.
// The per-thread bodies are ac_scan.cuh's ac_assoc_*.
//
// Bound: phase 1 does T*S dependent lookups by design of the formulation
// (the blocked scan does T), phases 2 and 3 are dependent chains of B and
// L lookups. delta sits in shared memory when its S*V*4 bytes fit 48 KB,
// so those lookups are shared-memory latency; the ids of a chunk are read
// by all its threads at once (a broadcast through L1). Bytes: ids in,
// states out, 8*T, far below what the lookups take.
#include <cuda_runtime.h>

#include "ac_scan.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int64_t kSmemBytes = 48 * 1024;

// delta in shared memory (when smem) or in device memory.
__device__ const int32_t* stage_delta(const AcScanArgs& a, int32_t* smem,
                                      bool use_smem) {
  if (!use_smem) return a.table;
  const int64_t n = (int64_t)a.n_states * a.V;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) smem[i] = a.table[i];
  __syncthreads();
  return smem;
}

__global__ void assoc_compose_kernel(AcScanArgs a, bool use_smem) {
  extern __shared__ int32_t smem[];
  const int32_t* delta = stage_delta(a, smem, use_smem);
  for (int32_t s = threadIdx.x; s < a.n_states; s += blockDim.x)
    ac_assoc_compose_state(a, delta, blockIdx.x, s);
}

__global__ void assoc_chain_kernel(AcScanArgs a) { ac_assoc_chain(a); }

__global__ void assoc_states_kernel(AcScanArgs a, bool use_smem) {
  extern __shared__ int32_t smem[];
  const int32_t* delta = stage_delta(a, smem, use_smem);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < a.B) ac_assoc_states_chunk(a, delta, c);
}

}  // namespace

extern "C" int ac_assoc_scan(const AcScanArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t table_bytes = (int64_t)a->n_states * a->V * 4;
  const bool use_smem = table_bytes <= kSmemBytes;
  const size_t smem = use_smem ? (size_t)table_bytes : 0;
  int threads = (a->n_states + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  assoc_compose_kernel<<<(unsigned)a->B, threads, smem, st>>>(*a, use_smem);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  assoc_chain_kernel<<<1, 1, 0, st>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((a->B + kThreads - 1) / kThreads);
  assoc_states_kernel<<<grid, kThreads, smem, st>>>(*a, use_smem);
  return (int)cudaGetLastError();
}
