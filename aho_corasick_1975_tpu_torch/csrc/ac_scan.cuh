// Per-stream automaton scans shared by the CUDA kernels (dense_scan.cu,
// stepped_scan.cu, sparse_scan.cu) and the g++ host shim (ac_scan_host.cpp)
// that the CPU tests run: one function per kernel, computing everything one
// stream (one CUDA thread) does.
//
// Layout: B streams of L symbols each over a contiguous ext buffer of
// halo + B*L symbols. Window row t of stream b (t in [0, halo + L)) is
// ext[b*L + t], so rows t < halo re-run the previous stream's last halo
// symbols (ops/blocking.py's exactness argument) and the window_layout
// transpose of ops/scan_xla.py is never materialised. The count_many
// kernels (K5, K6) run the same count bodies over another symbol accessor,
// AcBatchSyms: column i*n_docs + j is block i of document j of a
// time-major [doc_len, n_docs] batch (ops/scan_xla.py:split_docs_layout).
// The sparse prefilter's kernels (K7, K8 window form) run them over a third,
// AcWinSyms: column c is the window of live block idx[c], read in place
// from the stream (ops/sparse.py:_window_gather) or from host-elided
// windows.
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
  const int32_t* table;     // dflat [cap*V] (K1, K2, K6, K7 dense, K8) or
                            // packed [cap*V^k] (K3-K5, K7 stepped)
  const int32_t* nb_out;    // [cap] matches per state (K1, K6, K7 dense, K8)
  const void* ext;          // K1-K4, K8 stream: [halo + B*L] letter ids
                            // (int32) or raw symbols; K5, K6: the
                            // [doc_len, n_docs] batch tm; K7, K8 window: below
  const int32_t* lut;       // raw symbol -> letter id; null when ext holds ids
  const int32_t* head_ids;  // [halo] letter ids of stream 0's warm-up rows (raw)
  int32_t* out;             // K1, K3, K5, K6: [B] totals; K2: [B*L] states;
                            // K4: [B, L/k] emit
  int32_t* n_hits;          // K4, K8 pass 1: [B] matches per stream
  int32_t* n_live;          // K4: [B] grams with a match per stream;
                            // K8 pass 1: [B] hit positions per stream
  int64_t L;                // symbols per stream or block (a multiple of k)
  int64_t Vk;               // V^k
  int32_t B, V, halo;       // B streams or columns; halo in symbols
                            // (halo_steps*k for K3-K5)
  int32_t ext_u8;           // ext is uint8 (else int32)
  int32_t n_lut;
  int32_t k, count_bits;
  int64_t doc_len;          // K5, K6, K2 time-major: rows of tm
  int32_t n_docs;           // K5, K6, K2 time-major: columns of tm
                            // (B = c * n_docs)
  // K7, K8 windows: column c's window row t is
  // ext[(gather ? idx[c] : c) * col_stride + t * row_stride] (int32 ids);
  // its positions are idx[c]*L + t.
  const int32_t* idx;       // [B] block index of each column
  int64_t col_stride, row_stride;
  int32_t gather;           // 1: ext is the stream; 0: ext holds the windows
  // K8 pass 2 (null in pass 1): each column writes its hits, stream order,
  // from slot hit_off[c] on.
  int32_t* hit_pos;         // positions
  int32_t* hit_state;       // states after the symbol at each position
  const int64_t* hit_off;   // [B] first slot of each column
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

// Letter id at window row t of sparse column c (ops/sparse.py): the
// window of live block idx[c], halo rows included, read in place from the
// stream ext [halo + (nB+1)*L] (gather) or from host-elided time-major
// windows [halo + L, B] (ops/sparse.py:elide_windows). Ids only: the
// prefilter encodes (or LUT-translates) on the host first.
struct AcWinSyms {
  const int32_t* col;
  int64_t stride;

  AC_HD int32_t operator()(int64_t t) const { return col[t * stride]; }
};

AC_HD AcWinSyms ac_win_syms(const AcScanArgs& a, int64_t column) {
  AcWinSyms s;
  const int64_t base = a.gather ? (int64_t)a.idx[column] : column;
  s.col = (const int32_t*)a.ext + base * a.col_stride;
  s.stride = a.row_stride;
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

// K7 dense (ops/sparse.py:make_sparse_count / _dev over _window_gather,
// and the elided count of models/scanner.py:_elided_count_core): K1's
// recurrence over one live-block window.
AC_HD void ac_sparse_count_column(const AcScanArgs& a, int64_t column) {
  a.out[column] = ac_dense_count_body(a, ac_win_syms(a, column));
}

// K2: the state after each body symbol, out[t*ostride].
template <typename Syms>
AC_HD void ac_dense_states_body(const AcScanArgs& a, const Syms& sym,
                                int32_t* out, int64_t ostride) {
  int32_t s = 0;
  for (int64_t t = 0; t < a.halo; ++t) s = a.table[(int64_t)s * a.V + sym(t)];
  for (int64_t t = 0; t < a.L; ++t) {
    s = a.table[(int64_t)s * a.V + sym(a.halo + t)];
    out[t * ostride] = s;
  }
}

// K2 (ops/scan_xla.py:make_blocked_scan_stream / _raw), written in stream
// order; with B = 1 and halo 0 it is ops/scan_xla.py:make_sequential_scan.
template <typename T>
AC_HD void ac_dense_states_stream(const AcScanArgs& a, int64_t b) {
  ac_dense_states_body(a, ac_syms<T>(a, b), a.out + b * a.L, 1);
}

// K2 time-major (ops/scan_xla.py:make_blocked_scan): column j of a
// [L, n_docs] batch from the root, states written to out [L, n_docs].
template <typename T>
AC_HD void ac_dense_states_tm_column(const AcScanArgs& a, int64_t j) {
  ac_dense_states_body(a, ac_batch_syms<T>(a, j), a.out + j, a.n_docs);
}

// K8 (ops/hits.py:make_blocked_hits, ops/sparse.py:_window_hits_core): the
// K2 recurrence; a body row t hits when nb_out[s] > 0. Pass 1 (hit_pos
// null) writes the column's matches to n_hits and its hit positions to
// n_live; pass 2 re-runs the chain and writes (pos0 + t, s) of each hit
// from slot hit_off[column] on, so the output holds exactly the hits.
template <typename Syms>
AC_HD void ac_dense_hits_body(const AcScanArgs& a, const Syms& sym,
                              int64_t column, int64_t pos0) {
  int32_t s = 0;
  for (int64_t t = 0; t < a.halo; ++t) s = a.table[(int64_t)s * a.V + sym(t)];
  int64_t slot = a.hit_pos != nullptr ? a.hit_off[column] : 0;
  uint32_t hits = 0;
  int32_t n_pos = 0;
  for (int64_t t = 0; t < a.L; ++t) {
    s = a.table[(int64_t)s * a.V + sym(a.halo + t)];
    const int32_t nb = a.nb_out[s];
    if (nb > 0) {
      if (a.hit_pos != nullptr) {
        a.hit_pos[slot] = (int32_t)(pos0 + t);
        a.hit_state[slot] = s;
        ++slot;
      }
      hits += (uint32_t)nb;
      ++n_pos;
    }
  }
  if (a.hit_pos == nullptr) {
    a.n_hits[column] = (int32_t)hits;
    a.n_live[column] = n_pos;
  }
}

// K8 stream form (make_blocked_hits_stream / _raw): positions b*L + t.
template <typename T>
AC_HD void ac_dense_hits_stream(const AcScanArgs& a, int64_t b) {
  ac_dense_hits_body(a, ac_syms<T>(a, b), b, b * a.L);
}

// K8 window form (make_sparse_hits[_dev], make_elided_hits): positions
// idx[c]*L + t.
AC_HD void ac_window_hits_column(const AcScanArgs& a, int64_t column) {
  ac_dense_hits_body(a, ac_win_syms(a, column), column,
                     (int64_t)a.idx[column] * a.L);
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

// K7 stepped (ops/sparse.py:make_sparse_count_stepped / _dev, and the
// elided stepped count): K3's recurrence over one live-block window.
AC_HD void ac_sparse_count_stepped_column(const AcScanArgs& a,
                                          int64_t column) {
  a.out[column] = ac_stepped_count_body(a, ac_win_syms(a, column));
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
