// Per-stream automaton scans shared by the CUDA kernels (dense_scan.cu,
// stepped_scan.cu, sparse_scan.cu, mxu_scan.cu) and the g++ host shim
// (ac_scan_host.cpp) that the CPU tests run: one function per kernel,
// computing everything one stream (one CUDA thread) does; for the MXU
// engine (K10, K11's MMA half), everything one warp of R streams does,
// with the tensor-core instruction and the warp's votes and shuffles
// emulated lane by lane on the host.
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
#include <string.h>

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
  // K9: cnt_k [cap*V^k], the k-gram counts beside table = delta_k.
  const int32_t* table2;
  // K10, K11's MMA half: the digit planes keyed by (state, letter), int8
  // planes_t [n_planes, S_pad*V rounded up to 32]
  // (ops/scan_mxu.py:transpose_planes), and the count bits of their words.
  const int8_t* planes_t;
  int32_t S_pad, n_planes, count_bits_m;
  int32_t B1;               // K11: columns [0, B1) gather, [B1, B) MMA
  int32_t layout;           // K9, K10: 0 stream, 1 batch (tm), 2 windows
  // K12: table = delta [n_states, V], ext = ids int32 [doc_len], out =
  // states [doc_len], cut into B chunks of L symbols; compose [B, n_states]
  // each chunk's composed transition function, starts [B] each chunk's
  // start state.
  int32_t* compose;
  int32_t* starts;
  int32_t n_states;
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

// The k-gram tables of the stepped count: one packed word
// (next_state << count_bits) | gram_count per (state, gram), or, where
// (state, count) need more than 31 bits, two tables delta_k and cnt_k.
struct AcPackedTable {
  const int32_t* word;
  int32_t count_bits;

  AC_HD int32_t next(int64_t i, uint32_t* count) const {
    const int32_t v = word[i];
    *count = (uint32_t)v & ((1u << count_bits) - 1u);
    return v >> count_bits;
  }
};

struct AcTwoTables {
  const int32_t* delta_k;
  const int32_t* cnt_k;

  AC_HD int32_t next(int64_t i, uint32_t* count) const {
    *count = (uint32_t)cnt_k[i];
    return delta_k[i];
  }
};

AC_HD AcPackedTable ac_packed(const AcScanArgs& a) {
  AcPackedTable t;
  t.word = a.table;
  t.count_bits = a.count_bits;
  return t;
}

AC_HD AcTwoTables ac_two_tables(const AcScanArgs& a) {
  AcTwoTables t;
  t.delta_k = a.table;
  t.cnt_k = a.table2;
  return t;
}

// K3 (ops/multistep.py:stepped_count_core), K5
// (ops/multistep.py:_stepped_count_many_body) and K9
// (make_stepped_count_unpacked[_stream]): one table step per k symbols,
// counted past the halo grams. The table index is 64-bit: s*V^k can pass
// 2^31 where JAX's int32 would wrap.
template <typename Syms, typename Table>
AC_HD int32_t ac_stepped_count_body(const AcScanArgs& a, const Syms& sym,
                                    const Table& table) {
  const int64_t halo_steps = a.halo / a.k, n_steps = halo_steps + a.L / a.k;
  int32_t s = 0;
  uint32_t tot = 0;
  for (int64_t j = 0; j < n_steps; ++j) {
    uint32_t c;
    s = table.next((int64_t)s * a.Vk + ac_gram(sym, j * a.k, a.V, a.k), &c);
    if (j >= halo_steps) tot += c;
  }
  return (int32_t)tot;
}

template <typename T>
AC_HD void ac_stepped_count_stream(const AcScanArgs& a, int64_t b) {
  a.out[b] = ac_stepped_count_body(a, ac_syms<T>(a, b), ac_packed(a));
}

template <typename T>
AC_HD void ac_stepped_count_many_column(const AcScanArgs& a, int64_t column) {
  a.out[column] = ac_stepped_count_body(a, ac_batch_syms<T>(a, column),
                                        ac_packed(a));
}

// K9 stream form (ids or raw) and batch form (count_many's [L, B] ids,
// every column from the root).
template <typename T>
AC_HD void ac_stepped_count_2t_stream(const AcScanArgs& a, int64_t b) {
  a.out[b] = ac_stepped_count_body(a, ac_syms<T>(a, b), ac_two_tables(a));
}

AC_HD void ac_stepped_count_2t_column(const AcScanArgs& a, int64_t column) {
  a.out[column] = ac_stepped_count_body(a, ac_batch_syms<int32_t>(a, column),
                                        ac_two_tables(a));
}

// K7 stepped (ops/sparse.py:make_sparse_count_stepped / _dev, and the
// elided stepped count): K3's recurrence over one live-block window.
AC_HD void ac_sparse_count_stepped_column(const AcScanArgs& a,
                                          int64_t column) {
  a.out[column] = ac_stepped_count_body(a, ac_win_syms(a, column),
                                        ac_packed(a));
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

// ---------------------------------------------------------------------------
// K10 (ops/scan_mxu.py:mxu_count_core) and K11's MMA half
// (ops/scan_hybrid.py:hybrid_count_core): the automaton step as an int8
// tensor-core product keyed by (state, letter). planes_t [n_planes, K]
// (ops/scan_mxu.py:transpose_planes), K = S_pad * V rounded up to 32,
// holds at key s*V + c digit p of the packed word
// (next_state << count_bits_m) | count of state s and letter c. A warp
// owns R rows (columns col0 .. col0+R-1: streams, batch columns or
// windows; R = AC_K10_ROWS in K10, AC_K11_ROWS in K11) of an m16n8k32
// tile, rows past R zero. Row r's A row
// is the one-hot of its key s_r*V + c_r over a 32-key tile, B is the
// tile's 32 keys by 8 columns, column p plane p (columns past n_planes
// zero), so D's row r holds row r's digits and its word is
// e = sum_p digit_p << 7p. The step counts e & mask past the halo and
// moves to e >> count_bits_m.
//
// A row whose key lies outside a tile has an all-zero A row, so a step
// multiplies each distinct 32-key tile among its rows once, passing the
// running D as C: after the last one D holds every row's digits. Tiles are
// picked by warp votes (a ballot of the lanes with a pending row, the first
// such lane's tile broadcast), uniformly across the warp as mma.sync
// requires. Lane (g = lane >> 2, q = lane & 3) keeps the state, the next
// letters and the total of rows g and g+8, the rows its A fragment and D
// elements touch, in registers; the quad assembles each word from its D
// elements by two shuffles. At R = 1 every lane holds the one row, which
// fills all 16 A rows: its tile needs no vote. No step touches shared state
// or waits at a barrier.
//
// R is one constant per kernel, chosen on the card (PERF.md): K10's
// 16,384 streams keep every SM's issue slots busy, so its time follows the
// launch's products in all, least at R = 8; K11's few MMA columns run few
// warps, so its time follows one warp's chain, shortest at R = 1.
// probe_mxu_rows.py rebuilds the kernels at other values of these macros
// to time them, and at AC_MXU_FILL 0 to time the vote loop at R = 1.
#ifndef AC_K10_ROWS
#define AC_K10_ROWS 8
#endif
#ifndef AC_K11_ROWS
#define AC_K11_ROWS 1
#endif
#ifndef AC_MXU_FILL
#define AC_MXU_FILL 1
#endif

// Fragment index functions of mma.sync.aligned.m16n8k32.row.col.s32.s8.
// s8.s32 (PTX ISA, "Matrix Fragments for mma.m16n8k32"): for lane l, with
// groupID g = l >> 2 and threadID_in_group q = l & 3, element i of its A
// fragment (16 int8 in 4 registers, byte i & 3 of register i >> 2), of its
// B fragment (8 int8 in 2 registers) and of its C/D fragment (4 int32).
AC_HD int ac_frag_a_row(int lane, int i) {
  return (lane >> 2) + 8 * ((i >> 2) & 1);
}
AC_HD int ac_frag_a_col(int lane, int i) {
  return 4 * (lane & 3) + (i & 3) + 16 * (i >> 3);
}
AC_HD int ac_frag_b_row(int lane, int i) {
  return 4 * (lane & 3) + (i & 3) + 16 * (i >> 2);
}
AC_HD int ac_frag_b_col(int lane, int i) {
  (void)i;
  return lane >> 2;
}
AC_HD int ac_frag_c_row(int lane, int i) {
  return (lane >> 2) + 8 * (i >> 1);
}
AC_HD int ac_frag_c_col(int lane, int i) {
  return 2 * (lane & 3) + (i & 1);
}

// Per-lane values: one register on the card, one slot per lane on the host,
// where every per-lane statement runs for the 32 lanes in turn
// (AC_FOR_LANES) and the warp primitives below combine the slots as the
// card's instructions combine the lanes.
#if defined(__CUDA_ARCH__)
#define AC_LANE_SLOTS 1
#define AC_SLOT(i) 0
#define AC_FOR_LANES(l, lane) for (int l = (lane); l == (lane); l += 64)
#define AC_UNROLL _Pragma("unroll")
#else
#define AC_LANE_SLOTS 32
#define AC_SLOT(i) (i)
#define AC_FOR_LANES(l, lane) for (int l = 0; l < 32; ++l)
#define AC_UNROLL
#endif

// __ballot_sync: bit l set where lane l's predicate holds.
AC_HD uint32_t ac_ballot(const bool p[AC_LANE_SLOTS]) {
#if defined(__CUDA_ARCH__)
  return __ballot_sync(0xffffffffu, p[0]);
#else
  uint32_t m = 0;
  for (int l = 0; l < 32; ++l) m |= (uint32_t)p[l] << l;
  return m;
#endif
}

// __shfl_sync from lane src: its value, the same in every lane.
AC_HD int32_t ac_shfl(const int32_t v[AC_LANE_SLOTS], int src) {
#if defined(__CUDA_ARCH__)
  return __shfl_sync(0xffffffffu, v[0], src);
#else
  return v[src];
#endif
}

// __shfl_xor_sync: out[l] = in[l ^ m].
AC_HD void ac_shfl_xor(const uint32_t in[AC_LANE_SLOTS],
                       uint32_t out[AC_LANE_SLOTS], int m) {
#if defined(__CUDA_ARCH__)
  out[0] = __shfl_xor_sync(0xffffffffu, in[0], m);
#else
  for (int l = 0; l < 32; ++l) out[l] = in[l ^ m];
#endif
}

// The lowest set bit of a non-zero ballot (__ffs - 1).
AC_HD int ac_first_lane(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// Four bytes from a 4-aligned address, little-endian.
AC_HD uint32_t ac_load_u32(const int8_t* p) {
#if defined(__CUDA_ARCH__)
  return *(const uint32_t*)p;
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

#if defined(__CUDA_ARCH__)
// D = A x B + D.
__device__ __forceinline__ void ac_warp_mma(const uint32_t a[1][4],
                                            const uint32_t b[1][2],
                                            int32_t d[1][4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(b[0][0]), "r"(b[0][1]));
}
#else
// The warp's mma.sync on the host: assemble A [16 x 32] and B [32 x 8]
// from the 32 lanes' fragments by the index functions above, multiply in
// int32, and add to each lane's D elements.
inline void ac_warp_mma(const uint32_t a[32][4], const uint32_t b[32][2],
                        int32_t d[32][4]) {
  int32_t A[16][32], B[32][8];
  for (int l = 0; l < 32; ++l) {
    for (int i = 0; i < 16; ++i)
      A[ac_frag_a_row(l, i)][ac_frag_a_col(l, i)] =
          (int8_t)(a[l][i >> 2] >> (8 * (i & 3)));
    for (int i = 0; i < 8; ++i)
      B[ac_frag_b_row(l, i)][ac_frag_b_col(l, i)] =
          (int8_t)(b[l][i >> 2] >> (8 * (i & 3)));
  }
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 4; ++i) {
      int32_t acc = 0;
      for (int k = 0; k < 32; ++k)
        acc += A[ac_frag_c_row(l, i)][k] * B[k][ac_frag_c_col(l, i)];
      d[l][i] += acc;
    }
}
#endif

// The key axis of planes_t: S_pad * V rounded up to a whole 32-key tile.
AC_HD int32_t ac_key_stride(const AcScanArgs& a) {
  return (int32_t)(((int64_t)a.S_pad * a.V + 31) & ~(int64_t)31);
}

// Lane l's A fragment for key tile `tile`: for each of its pending rows
// (g + 8h) whose key falls in the tile, a 1 at the key's column where the
// fragment holds it (register h for columns 0-15, 2 + h for 16-31); those
// rows are then no longer pending. Branch-free, every register index
// fixed at compile time, so that the fragment never leaves registers.
template <int H>
AC_HD void ac_mxu_frag_a(int lane, int32_t tile, const int32_t* key,
                         bool* pend, uint32_t a[4]) {
  a[0] = a[1] = a[2] = a[3] = 0;
  AC_UNROLL
  for (int h = 0; h < H; ++h) {
    const bool in = pend[h] && (key[h] >> 5) == tile;
    pend[h] = pend[h] && !in;
    const int o = key[h] & 31;
    const uint32_t v =
        in && ((o >> 2) & 3) == (lane & 3) ? 1u << (8 * (o & 3)) : 0u;
    a[h] = (o >> 4) ? 0u : v;
    a[2 + h] = (o >> 4) ? v : 0u;
  }
}

// Lane l's B fragment for key tile `tile`: keys tile*32 + 4q .. +3 and
// +16 .. +19 of plane g, two aligned 32-bit loads; zero for g >= n_planes
// (those lanes load plane 0's and drop it, so the warp never diverges).
AC_HD void ac_mxu_frag_b(const int8_t* planes_t, int32_t K, int n_planes,
                         int lane, int32_t tile, uint32_t b[2]) {
  const int p = lane >> 2;
  const bool on = p < n_planes;
  const int8_t* row = planes_t + (on ? p * K : 0) + tile * 32 + 4 * (lane & 3);
  const uint32_t lo = ac_load_u32(row), hi = ac_load_u32(row + 16);
  b[0] = on ? lo : 0u;
  b[1] = on ? hi : 0u;
}

// Lane l's share of row (g + 8h)'s word: its D elements of that row are
// the digits of planes 2q and 2q + 1.
AC_HD uint32_t ac_mxu_digits(const int32_t d[4], int lane, int h,
                             int n_planes) {
  const int p = 2 * (lane & 3);
  uint32_t w = 0;
  if (p < n_planes) w |= (uint32_t)d[2 * h] << (7 * p);
  if (p + 1 < n_planes) w |= (uint32_t)d[2 * h + 1] << (7 * (p + 1));
  return w;
}

// The symbol accessors of the three layouts, as types.
template <typename T>
struct AcStreamLayout {
  typedef AcSyms<T> Syms;
  AC_HD static Syms make(const AcScanArgs& a, int64_t c) {
    return ac_syms<T>(a, c);
  }
};

template <typename T>
struct AcBatchLayout {
  typedef AcBatchSyms<T> Syms;
  AC_HD static Syms make(const AcScanArgs& a, int64_t c) {
    return ac_batch_syms<T>(a, c);
  }
};

struct AcWinLayout {
  typedef AcWinSyms Syms;
  AC_HD static Syms make(const AcScanArgs& a, int64_t c) {
    return ac_win_syms(a, c);
  }
};

// Symbols each row loads ahead of its chain, in a ring of registers.
#define AC_MXU_AHEAD 4

// The MXU count of the R columns col0 .. col0+R-1 (those below a.B), over
// planes_t (in shared or global memory): a.halo warm-up rows, then a.L
// counted rows; out[col] is the column's int32 total. At R = 1 every lane
// holds the one row and it fills all 16 A rows, so a step is one product
// of its own tile, with no vote, and every quad's D holds its word.
template <int R, typename Layout>
AC_HD void ac_mxu_warp(const AcScanArgs& a, const int8_t* planes_t, int lane,
                       int64_t col0) {
  (void)lane;  // the host runs every lane
  const int H = R > 8 ? 2 : 1;   // rows g and g + 8 of each lane, below R
  const bool fill = R == 1 && AC_MXU_FILL;   // one row in all 16 A rows
  const int P = AC_MXU_AHEAD;
  const int32_t K = ac_key_stride(a), V = a.V;
  const int n_planes = a.n_planes;
  const uint32_t mask = (1u << a.count_bits_m) - 1u;
  const int64_t T = (int64_t)a.halo + a.L;
  typename Layout::Syms syms[AC_LANE_SLOTS][H];
  bool live[AC_LANE_SLOTS][H];
  int32_t st[AC_LANE_SLOTS][H], key[AC_LANE_SLOTS][H];
  int32_t ring[AC_LANE_SLOTS][H][P];
  uint32_t tot[AC_LANE_SLOTS][H];
  // every index of these arrays is fixed at compile time (the loops over
  // h and j unroll), so that they stay in registers on the card
  AC_FOR_LANES(l, lane) {
    const int s = AC_SLOT(l);
    AC_UNROLL
    for (int h = 0; h < H; ++h) {
      const int r = fill ? 0 : (l >> 2) + 8 * h;
      live[s][h] = r < R && col0 + r < a.B;
      st[s][h] = 0;
      key[s][h] = -1;  // a dead row never falls in a tile
      tot[s][h] = 0;
      if (live[s][h]) syms[s][h] = Layout::make(a, col0 + r);
      AC_UNROLL
      for (int j = 0; j < P; ++j)
        ring[s][h][j] = live[s][h] && j < T ? syms[s][h](j) : 0;
    }
  }
  for (int64_t t0 = 0; t0 < T; t0 += P) {
    AC_UNROLL
    for (int j = 0; j < P; ++j) {
      const int64_t t = t0 + j;
      if (t >= T) break;
      // this step's keys; ring slot j is refilled P symbols ahead
      bool pend[AC_LANE_SLOTS][H];
      AC_FOR_LANES(l, lane) {
        const int s = AC_SLOT(l);
        AC_UNROLL
        for (int h = 0; h < H; ++h) {
          pend[s][h] = live[s][h];
          if (!live[s][h]) continue;
          key[s][h] = st[s][h] * V + ring[s][h][j];
          if (t + P < T) ring[s][h][j] = syms[s][h](t + P);
        }
      }
      // one product per distinct key tile, accumulated in D
      int32_t d[AC_LANE_SLOTS][4];
      AC_FOR_LANES(l, lane) {
        for (int i = 0; i < 4; ++i) d[AC_SLOT(l)][i] = 0;
      }
      if (fill) {
        uint32_t fa[AC_LANE_SLOTS][4], fb[AC_LANE_SLOTS][2];
        AC_FOR_LANES(l, lane) {
          const int s = AC_SLOT(l);
          const int32_t both[2] = {key[s][0], key[s][0]};
          bool rows[2] = {true, true};
          ac_mxu_frag_a<2>(l, key[s][0] >> 5, both, rows, fa[s]);
          ac_mxu_frag_b(planes_t, K, n_planes, l, key[s][0] >> 5, fb[s]);
        }
        ac_warp_mma(fa, fb, d);
      }
      while (!fill) {
        bool any[AC_LANE_SLOTS];
        int32_t lt[AC_LANE_SLOTS];
        AC_FOR_LANES(l, lane) {
          const int s = AC_SLOT(l);
          any[s] = pend[s][0] || pend[s][H - 1];
          lt[s] = (pend[s][0] ? key[s][0] : key[s][H - 1]) >> 5;
        }
        const uint32_t voters = ac_ballot(any);
        if (voters == 0) break;
        const int32_t tile = ac_shfl(lt, ac_first_lane(voters));
        uint32_t fa[AC_LANE_SLOTS][4], fb[AC_LANE_SLOTS][2];
        AC_FOR_LANES(l, lane) {
          const int s = AC_SLOT(l);
          ac_mxu_frag_a<H>(l, tile, key[s], pend[s], fa[s]);
          ac_mxu_frag_b(planes_t, K, n_planes, l, tile, fb[s]);
        }
        ac_warp_mma(fa, fb, d);
      }
      // each row's word, gathered across its quad; count and move
      AC_UNROLL
      for (int h = 0; h < H; ++h) {
        uint32_t w[AC_LANE_SLOTS], x[AC_LANE_SLOTS];
        AC_FOR_LANES(l, lane) {
          w[AC_SLOT(l)] = ac_mxu_digits(d[AC_SLOT(l)], l, h, n_planes);
        }
        ac_shfl_xor(w, x, 1);
        AC_FOR_LANES(l, lane) { w[AC_SLOT(l)] |= x[AC_SLOT(l)]; }
        ac_shfl_xor(w, x, 2);
        AC_FOR_LANES(l, lane) {
          const int s = AC_SLOT(l);
          const uint32_t e = w[s] | x[s];
          if (!live[s][h]) continue;
          if (t >= a.halo) tot[s][h] += e & mask;
          st[s][h] = (int32_t)(e >> a.count_bits_m);
        }
      }
    }
  }
  AC_FOR_LANES(l, lane) {
    const int s = AC_SLOT(l);
    for (int h = 0; h < H; ++h) {
      if (live[s][h] && (fill ? l == 0 : (l & 3) == 0))
        a.out[col0 + (fill ? 0 : (l >> 2) + 8 * h)] = (int32_t)tot[s][h];
    }
  }
}

// K12, the associative-scan formulation (ops/scan_assoc.py): the states
// after every symbol from the root, by chunked composition of the symbols'
// transition functions f_c = delta[:, c]. Three phases, each a per-thread
// body: (1) chunk c's composed function at state s, for every s (T*S
// lookups in all, by design of the formulation); (2) the chunks' start
// states chained through those functions, one thread; (3) each chunk re-run
// from its start state, writing its states. ``delta`` may point into shared
// memory.
AC_HD int32_t ac_assoc_run(const int32_t* delta, int32_t V,
                           const int32_t* ids, int64_t t0, int64_t t1,
                           int32_t s) {
  for (int64_t t = t0; t < t1; ++t) s = delta[(int64_t)s * V + ids[t]];
  return s;
}

AC_HD void ac_assoc_compose_state(const AcScanArgs& a, const int32_t* delta,
                                  int64_t c, int32_t s) {
  const int64_t t0 = c * a.L;
  const int64_t t1 = t0 + a.L < a.doc_len ? t0 + a.L : a.doc_len;
  a.compose[c * a.n_states + s] =
      ac_assoc_run(delta, a.V, (const int32_t*)a.ext, t0, t1, s);
}

AC_HD void ac_assoc_chain(const AcScanArgs& a) {
  int32_t s = 0;
  for (int64_t c = 0; c < a.B; ++c) {
    a.starts[c] = s;
    s = a.compose[c * a.n_states + s];
  }
}

AC_HD void ac_assoc_states_chunk(const AcScanArgs& a, const int32_t* delta,
                                 int64_t c) {
  const int32_t* ids = (const int32_t*)a.ext;
  const int64_t t0 = c * a.L;
  const int64_t t1 = t0 + a.L < a.doc_len ? t0 + a.L : a.doc_len;
  int32_t s = a.starts[c];
  for (int64_t t = t0; t < t1; ++t) {
    s = delta[(int64_t)s * a.V + ids[t]];
    a.out[t] = s;
  }
}
