// Per-stream automaton scans shared by the CUDA kernels (dense_scan.cu,
// stepped_scan.cu) and the g++ host shim (ac_scan_host.cpp) that the CPU
// tests run: one function per kernel, computing everything one stream
// (one CUDA thread) does.
//
// Layout: B streams of L symbols each over a contiguous ext buffer of
// halo + B*L symbols. Window row t of stream b (t in [0, halo + L)) is
// ext[b*L + t], so rows t < halo re-run the previous stream's last halo
// symbols (ops/blocking.py's exactness argument) and the window_layout
// transpose of ops/scan_xla.py is never materialised. The count_many
// kernels (K5, K6) run the same count bodies over another symbol accessor,
// AcBatchSyms: column i*n_docs + j is block i of document j of a
// time-major [doc_len, n_docs] batch (ops/scan_xla.py:split_docs_layout).
//
// What bounds these scans on an H100: each step's table index depends on
// the previous step's gather, so a stream is a chain of dependent loads
// (L2 or device-memory latency, not bandwidth). In the stream layout
// neighbouring threads read ext L symbols apart, so symbol loads are
// uncoalesced; in the batch layout neighbouring threads read neighbouring
// columns of one row, so a warp's symbol loads coalesce. 16,384 threads
// fill a few percent of the card's thread slots. Shared-memory tables are
// left for later work.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define AC_HD __host__ __device__ __forceinline__
#else
#define AC_HD inline
#endif

// Arguments of one launch. Passed by pointer through the C entry points
// and by value to the kernels; the Python side mirrors it in ops/build.py.
struct AcScanArgs {
  const int32_t* table;     // dflat [cap*V] (K1, K2, K6) or packed [cap*V^k] (K3-K5)
  const int32_t* nb_out;    // [cap] matches per state (K1, K6)
  const void* ext;          // K1-K4: [halo + B*L] letter ids (int32) or raw
                            // symbols; K5, K6: the [doc_len, n_docs] batch tm
  const int32_t* lut;       // raw symbol -> letter id; null when ext holds ids
  const int32_t* head_ids;  // [halo] letter ids of stream 0's warm-up rows (raw)
  int32_t* out;             // K1, K3, K5, K6: [B] totals; K2: [B*L] states;
                            // K4: [B, L/k] emit
  int32_t* n_hits;          // K4: [B] matches per stream
  int32_t* n_live;          // K4: [B] grams with a match per stream
  int64_t L;                // symbols per stream or block (a multiple of k)
  int64_t Vk;               // V^k
  int32_t B, V, halo;       // B streams or columns; halo in symbols
                            // (halo_steps*k for K3-K5)
  int32_t ext_u8;           // ext is uint8 (else int32)
  int32_t n_lut;
  int32_t k, count_bits;
  int64_t doc_len;          // K5, K6: rows of tm
  int32_t n_docs;           // K5, K6: columns of tm (B = c * n_docs)
};

// Letter id of one symbol: raw symbols translate through the LUT with the
// index clamped to its last entry (XLA's gather clamps; models/scanner.py
// mirrors that for pipelined halo heads); without a LUT the symbol is the id.
template <typename T>
AC_HD int32_t ac_lookup(T v, const int32_t* lut, int32_t n_lut) {
  if (lut == nullptr) return (int32_t)v;
  const uint32_t r = (uint32_t)v;
  const uint32_t last = (uint32_t)(n_lut - 1);
  return lut[r < last ? r : last];
}

// Letter id at window row t of one stream; stream 0's halo rows come from
// head_ids on the raw path (ops/scan_xla.py:raw_window).
template <typename T>
struct AcSyms {
  const T* row;
  const int32_t* lut;
  const int32_t* head;
  int32_t n_lut, halo;

  AC_HD int32_t operator()(int64_t t) const {
    if (head != nullptr && t < halo) return head[t];
    return ac_lookup(row[t], lut, n_lut);
  }
};

template <typename T>
AC_HD AcSyms<T> ac_syms(const AcScanArgs& a, int64_t b) {
  AcSyms<T> s;
  s.row = (const T*)a.ext + b * a.L;
  s.lut = a.lut;
  s.head = (b == 0 && a.lut != nullptr && a.halo > 0) ? a.head_ids : nullptr;
  s.n_lut = a.n_lut;
  s.halo = a.halo;
  return s;
}

// Letter id at window row t of batch column i*n_docs + j: row i*L + t - halo
// of document j, read from tm[row*n_docs + j]. Rows outside [0, doc_len)
// (before the document's head, and the padding past c*L) are id 0, and the
// LUT applies only inside: the reference pads in id space after its LUT
// gather (ops/scan_xla.py:split_docs_layout).
template <typename T>
struct AcBatchSyms {
  const T* col;
  const int32_t* lut;
  int64_t r0, n_rows, stride;
  int32_t n_lut;

  AC_HD int32_t operator()(int64_t t) const {
    const int64_t r = r0 + t;
    if (r < 0 || r >= n_rows) return 0;
    return ac_lookup(col[r * stride], lut, n_lut);
  }
};

template <typename T>
AC_HD AcBatchSyms<T> ac_batch_syms(const AcScanArgs& a, int64_t column) {
  AcBatchSyms<T> s;
  const int64_t i = column / a.n_docs, j = column % a.n_docs;
  s.col = (const T*)a.ext + j;
  s.lut = a.lut;
  s.r0 = i * a.L - a.halo;
  s.n_rows = a.doc_len;
  s.stride = a.n_docs;
  s.n_lut = a.n_lut;
  return s;
}

// k-gram id of the k symbols from row t0, in ops/multistep.py:combine_grams
// order.
template <typename Syms>
AC_HD int64_t ac_gram(const Syms& sym, int64_t t0, int32_t V, int32_t k) {
  int64_t g = sym(t0);
  for (int32_t i = 1; i < k; ++i) g = g * V + sym(t0 + i);
  return g;
}

// K1 (ops/scan_pallas.py:make_pallas_blocked_count, which computes
// ops/scan_xla.py:blocked_count_core) and K6 (ops/scan_xla.py:_count_many_body):
// s <- dflat[s*V + c]; matches of the rows past the halo. Sums wrap like
// the JAX int32 accumulator; the scanner's _guard_acc keeps them from
// doing so.
template <typename Syms>
AC_HD int32_t ac_dense_count_body(const AcScanArgs& a, const Syms& sym) {
  int32_t s = 0;
  uint32_t tot = 0;
  for (int64_t t = 0; t < a.halo; ++t) s = a.table[(int64_t)s * a.V + sym(t)];
  for (int64_t t = a.halo; t < a.halo + a.L; ++t) {
    s = a.table[(int64_t)s * a.V + sym(t)];
    tot += (uint32_t)a.nb_out[s];
  }
  return (int32_t)tot;
}

template <typename T>
AC_HD void ac_dense_count_stream(const AcScanArgs& a, int64_t b) {
  a.out[b] = ac_dense_count_body(a, ac_syms<T>(a, b));
}

template <typename T>
AC_HD void ac_dense_count_many_column(const AcScanArgs& a, int64_t column) {
  a.out[column] = ac_dense_count_body(a, ac_batch_syms<T>(a, column));
}

// K2 (ops/scan_xla.py:make_blocked_scan_stream / _raw): the state after
// each body symbol, written in stream order.
template <typename T>
AC_HD void ac_dense_states_stream(const AcScanArgs& a, int64_t b) {
  const AcSyms<T> sym = ac_syms<T>(a, b);
  int32_t* out = a.out + b * a.L;
  int32_t s = 0;
  for (int64_t t = 0; t < a.halo; ++t) s = a.table[(int64_t)s * a.V + sym(t)];
  for (int64_t t = 0; t < a.L; ++t) {
    s = a.table[(int64_t)s * a.V + sym(a.halo + t)];
    out[t] = s;
  }
}

// K3 (ops/multistep.py:stepped_count_core) and K5
// (ops/multistep.py:_stepped_count_many_body): one gather of the packed
// (next_state << count_bits) | gram_count table per k symbols. The table
// index is 64-bit: s*V^k can pass 2^31 where JAX's int32 would wrap.
template <typename Syms>
AC_HD int32_t ac_stepped_count_body(const AcScanArgs& a, const Syms& sym) {
  const uint32_t mask = (1u << a.count_bits) - 1u;
  const int64_t halo_steps = a.halo / a.k, n_steps = halo_steps + a.L / a.k;
  int32_t s = 0;
  uint32_t tot = 0;
  for (int64_t j = 0; j < n_steps; ++j) {
    const int32_t v = a.table[(int64_t)s * a.Vk + ac_gram(sym, j * a.k, a.V, a.k)];
    s = v >> a.count_bits;
    if (j >= halo_steps) tot += (uint32_t)v & mask;
  }
  return (int32_t)tot;
}

template <typename T>
AC_HD void ac_stepped_count_stream(const AcScanArgs& a, int64_t b) {
  a.out[b] = ac_stepped_count_body(a, ac_syms<T>(a, b));
}

template <typename T>
AC_HD void ac_stepped_count_many_column(const AcScanArgs& a, int64_t column) {
  a.out[column] = ac_stepped_count_body(a, ac_batch_syms<T>(a, column));
}

// K4 (ops/hits.py:_stepped_emit_scan): the K3 recurrence, writing per body
// gram the PRE-step state with the gram's count, (s << count_bits) | count,
// stream-major [B, L/k], plus the stream's match and live-gram counts.
template <typename T>
AC_HD void ac_stepped_emit_stream(const AcScanArgs& a, int64_t b) {
  const AcSyms<T> sym = ac_syms<T>(a, b);
  const uint32_t mask = (1u << a.count_bits) - 1u;
  const int64_t halo_steps = a.halo / a.k, n_body = a.L / a.k;
  int32_t* emit = a.out + b * n_body;
  int32_t s = 0;
  for (int64_t j = 0; j < halo_steps; ++j)
    s = a.table[(int64_t)s * a.Vk + ac_gram(sym, j * a.k, a.V, a.k)] >> a.count_bits;
  uint32_t hits = 0;
  int32_t live = 0;
  for (int64_t j = 0; j < n_body; ++j) {
    const int64_t t0 = a.halo + j * a.k;
    const int32_t v = a.table[(int64_t)s * a.Vk + ac_gram(sym, t0, a.V, a.k)];
    const uint32_t c = (uint32_t)v & mask;
    emit[j] = (int32_t)(((uint32_t)s << a.count_bits) | c);
    s = v >> a.count_bits;
    hits += c;
    live += c != 0;
  }
  a.n_hits[b] = (int32_t)hits;
  a.n_live[b] = live;
}
