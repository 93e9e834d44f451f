// Per-stream automaton scans shared by the CUDA kernels (dense_scan.cu,
// stepped_scan.cu, sparse_scan.cu, mxu_scan.cu) and the g++ host shim
// (ac_scan_host.cpp) that the CPU tests run: one function per kernel,
// computing everything one stream or sub-stream (one CUDA thread) does;
// for the MXU engine (K10, K11's MMA half), everything one warp of R
// streams does, with the tensor-core instruction and the warp's votes and
// shuffles emulated lane by lane on the host.
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
// windows; K7 dense reads the stream's windows through the first
// (AcWinRowsLayout).
//
// What bounds these scans on an H100: each step's table index depends on
// the previous step's gather, so a stream is a chain of dependent loads
// (L2 or device-memory latency, not bandwidth), and one thread per stream
// (16,384 at the slice) fills a few percent of the card's thread slots.
// The stepped counts (K3, K5, K9, K11's gather half), K4's emit and the
// 1-char scans (K1, K2, K6, K7 dense, K8: the same walk at k = 1 over
// AcDenseTable) therefore split each stream or column into P sub-streams
// (ac_stepped_part_walk), each warmed up from the root over warm_steps
// grams before its body, so that B*P threads fill the SMs; the symbols of
// the next group of steps are loaded (evict-first) while this group's
// gathers run, and the table is read through the read-only path, or for
// the 1-char stream forms (K1, K2, K7 dense, K8) from shared memory where
// it fits (ac_dense_stage). In the stream layout a sub-stream's symbols
// are contiguous: a byte stream's are loaded as 32-bit words, and at
// k = 1 every stream's as 16-byte vectors; in the batch layout
// neighbouring threads read neighbouring columns of one row, so a warp's
// symbol loads coalesce. K2's one-chain form (one stream at P = 1, the
// sequential scan) walks chunks of ids the rest of its block stages
// (ac_seq_walk).
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
  const int32_t* nb_out;    // [cap] matches per state (K1, K6, K7 dense,
                            // K8); null for K2
  const void* ext;          // K1-K4, K8 stream: [halo + B*L] letter ids
                            // (int32) or raw symbols; K5, K6: the
                            // [doc_len, n_docs] batch tm; K7, K8 window: below
  const int32_t* lut;       // raw symbol -> letter id; null when ext holds ids
  const int32_t* head_ids;  // [halo] letter ids of stream 0's warm-up rows (raw)
  int32_t* out;             // K1, K3, K5, K6: [B] totals; K2: [B*L] states
                            // ([L, B] time-major); K4: [B, L/k] emit
  int32_t* n_hits;          // K4: [B] matches per stream; K8 pass 1:
                            // [B*P] matches per sub-stream
  int32_t* n_live;          // K4: [B] grams with a match per stream;
                            // K8 pass 1: [B*P] hit positions per sub-stream
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
  // K8 pass 2 (null in pass 1): each sub-stream writes its hits, stream
  // order, from slot hit_off[g] on.
  int32_t* hit_pos;         // positions
  int32_t* hit_state;       // states after the symbol at each position
  const int64_t* hit_off;   // [B*P] first slot of each sub-stream
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
  // states [doc_len], cut into B chunks of L symbols and the chunks into
  // tiles of `tile`; compose [B + n_tiles, n_states] each chunk's composed
  // transition function, then each tile's; starts [B] each chunk's start
  // state. K1, K2, K7 dense, K8: the tables' real rows, those staged on
  // the SM.
  int32_t* compose;
  int32_t* starts;
  int32_t n_states;
  int32_t tile;
  // K1-K6, K7 dense, K8, K9, K11's gather half: the grams a sub-stream
  // reads before its body (never the halo, which may be shorter or 0;
  // symbols at k = 1): ceil((max_depth - 1) / k) of the tables for the
  // counts and states, which are exact from the body's first symbol on;
  // for K4, which also writes the state before that symbol,
  // ceil(max_depth / k).
  // And the sub-streams per column, a power of two up to AC_MAX_SPLIT; 0
  // lets the launcher pick (ac_pick_split).
  int32_t warm_steps;
  int32_t split;
  // K1, K2, K7 dense, K8: 1 reads the 1-char tables through the read-only
  // path even where rows [0, n_states) fit on the SM
  // (ac_dense_smem_bytes).
  int32_t global_table;
};

// Loads with an evict-first, streaming hint (the corpus, read once), so
// that the corpus does not push the tables out of L2.
template <typename T>
AC_HD T ac_ldcs(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldcs(p);
#else
  return *p;
#endif
}

// The stepped tables' gathers, through the read-only path (ld.global.nc,
// cached in L1).
template <typename T>
AC_HD T ac_ldtab(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// Bytes sh .. sh + 3 of the little-endian pair lo, hi (sh in 0-3).
AC_HD uint32_t ac_funnel(uint32_t lo, uint32_t hi, int sh) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, 8 * sh);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (8 * sh));
#endif
}

// Gram steps whose symbols the stepped counts load one group ahead
// (ac_stepped_walk), per layout: a stream's contiguous symbols and a
// batch's or windows' rows, each a multiple of 4 so that a group of a
// byte stream is whole 32-bit words at every k. Chosen on the card: a
// stream group of 4 and a batch group of 8 were slower (PERF.md).
constexpr int kStreamGroup = 8;
constexpr int kBatchGroup = 4;
static_assert(kStreamGroup % 4 == 0 && kBatchGroup % 4 == 0,
              "step groups are multiples of 4");

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
  static constexpr int kGroup = kStreamGroup;
  const T* row;
  const int32_t* lut;
  const int32_t* head;
  int32_t n_lut, halo;

  AC_HD int32_t operator()(int64_t t) const {
    if (head != nullptr && t < halo) return head[t];
    return ac_lookup(row[t], lut, n_lut);
  }

  // operator() in two halves: the load, issued ahead of its use, and the
  // letter id of what it loaded.
  AC_HD int32_t load(int64_t t) const {
    if (head != nullptr && t < halo) return head[t];
    return (int32_t)ac_ldcs(row + t);
  }
  AC_HD int32_t id(int64_t t, int32_t v) const {
    if (head != nullptr && t < halo) return v;
    return ac_lookup(v, lut, n_lut);
  }
  // The letter id at row t of the raw symbol v read from the row itself.
  AC_HD int32_t id_of_row(int64_t t, int32_t v) const {
    if (head != nullptr && t < halo) return head[t];
    return ac_lookup(v, lut, n_lut);
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
  static constexpr int kGroup = kBatchGroup;
  const T* col;
  const int32_t* lut;
  int64_t r0, n_rows, stride;
  int32_t n_lut;

  AC_HD int32_t operator()(int64_t t) const {
    const int64_t r = r0 + t;
    if (r < 0 || r >= n_rows) return 0;
    return ac_lookup(col[r * stride], lut, n_lut);
  }

  AC_HD int32_t load(int64_t t) const {
    const int64_t r = r0 + t;
    return r < 0 || r >= n_rows ? 0 : (int32_t)ac_ldcs(col + r * stride);
  }
  AC_HD int32_t id(int64_t t, int32_t v) const {
    const int64_t r = r0 + t;
    return r < 0 || r >= n_rows ? 0 : ac_lookup(v, lut, n_lut);
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
  static constexpr int kGroup = kBatchGroup;
  const int32_t* col;
  int64_t stride;

  AC_HD int32_t operator()(int64_t t) const { return col[t * stride]; }
  AC_HD int32_t load(int64_t t) const { return ac_ldcs(col + t * stride); }
  AC_HD int32_t id(int64_t, int32_t v) const { return v; }
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

// The k-gram tables of the stepped count: one packed word
// (next_state << count_bits) | gram_count per (state, gram), or, where
// (state, count) need more than 31 bits, two tables delta_k and cnt_k.
// Both are read through the read-only path.
struct AcPackedTable {
  const int32_t* word;
  int32_t count_bits;

  AC_HD int32_t next(int64_t i, uint32_t* count) const {
    const int32_t v = ac_ldtab(word + i);
    *count = (uint32_t)v & ((1u << count_bits) - 1u);
    return v >> count_bits;
  }
  AC_HD static AcPackedTable make(const AcScanArgs& a) {
    AcPackedTable t;
    t.word = a.table;
    t.count_bits = a.count_bits;
    return t;
  }
};

struct AcTwoTables {
  const int32_t* delta_k;
  const int32_t* cnt_k;

  AC_HD int32_t next(int64_t i, uint32_t* count) const {
    *count = (uint32_t)ac_ldtab(cnt_k + i);
    return ac_ldtab(delta_k + i);
  }
  AC_HD static AcTwoTables make(const AcScanArgs& a) {
    AcTwoTables t;
    t.delta_k = a.table;
    t.cnt_k = a.table2;
    return t;
  }
};

AC_HD AcPackedTable ac_packed(const AcScanArgs& a) {
  return AcPackedTable::make(a);
}

// The 1-char tables (K1, K2, K6, K8) as a gram table at k = 1: s' =
// dflat[i] and, with Counts, its matches nb_out[s'], which the next step
// does not wait for (it needs only s'); K2's states need no count. Row
// int32: the tables in device memory, through the read-only path (faster
// than plain loads for K6 at config 3, PERF.md); Row uint16: rows
// [0, n_states) staged on the SM (ac_dense_stage), read by plain loads.
template <typename Row, bool Counts = true>
struct AcDenseTable {
  // Rows on the SM: at most 65,536 states of 2-byte entries in a block's
  // shared memory, so an entry's index fits 32 bits.
  static constexpr bool kOnSm = sizeof(Row) == 2;
  const Row* dflat;
  const int32_t* nb_out;

  AC_HD int32_t next(int64_t i, uint32_t* count) const {
    if constexpr (kOnSm) {
      const int32_t s = dflat[i];
      *count = Counts ? (uint32_t)nb_out[s] : 0u;
      return s;
    } else {
      const int32_t s = ac_ldtab(dflat + i);
      *count = Counts ? (uint32_t)ac_ldtab(nb_out + s) : 0u;
      return s;
    }
  }
  AC_HD static AcDenseTable make(const AcScanArgs& a) {
    AcDenseTable t;
    t.dflat = a.table;
    t.nb_out = a.nb_out;
    return t;
  }
};

// The launch fields of a 1-char launch as a gram launch at k = 1.
AC_HD AcScanArgs ac_dense_args(AcScanArgs a) {
  a.k = 1;
  a.Vk = a.V;
  return a;
}

// LUT entries a launch serves from shared memory: all where there are at
// most kLutSmem, else none.
constexpr int kLutSmem = 4096;

AC_HD int32_t ac_lut_entries(const AcScanArgs& a) {
  return (a.lut != nullptr && a.n_lut <= kLutSmem) ? a.n_lut : 0;
}

// Shared memory a block can hold on an H100 (sm_90).
#define AC_SMEM_BLOCK 232448

// Threads a block of the 1-char stream kernels (K1, K2, K7 dense, K8):
// their tables in device memory, or on the SM (and K2's one-chain block).
constexpr int kDenseThreads = 128;
constexpr int kDenseSmThreads = 512;

// Bytes of shared memory the 1-char tables take on the SM beside `beside`
// bytes of the block's other shared memory (the LUT, staged outputs, K2's
// chunks): nb_out's rows [0, n_states) as int32 where the launch has
// nb_out (K2 has none), then dflat's as uint16 (a state id fits 16 bits);
// 0 where they stay in device memory: forced (global_table), n_states
// unset, past 65,536 states, or over the bytes a block can hold. At the
// slice's 3,919 states and V = 12, 110 KB (94 KB without nb_out).
AC_HD int64_t ac_dense_smem_bytes(const AcScanArgs& a, int64_t beside) {
  if (a.global_table || a.n_states <= 0 || a.n_states > 65536) return 0;
  const int64_t bytes = (a.nb_out != nullptr ? 4 * (int64_t)a.n_states : 0) +
                        ((2 * (int64_t)a.n_states * a.V + 3) & ~3);
  return beside + bytes <= AC_SMEM_BLOCK ? bytes : 0;
}

// Thread tid of n copies the 1-char tables' rows [0, n_states) into smem
// (ac_dense_smem_bytes of room; nb_out first, with Counts), dflat four
// entries a load where it is 16-byte aligned; the table they make once
// every thread has copied.
template <bool Counts = true>
AC_HD AcDenseTable<uint16_t, Counts> ac_dense_stage(const AcScanArgs& a,
                                                    int32_t* smem, int tid,
                                                    int n) {
  const int64_t S = a.n_states, entries = S * a.V;
  uint16_t* rows = (uint16_t*)(smem + (Counts ? S : 0));
  if constexpr (Counts)
    for (int64_t i = tid; i < S; i += n) smem[i] = ac_ldtab(a.nb_out + i);
  const int64_t quads = ((uintptr_t)a.table & 15) ? 0 : entries / 4;
  uint32_t* pairs = (uint32_t*)rows;
#if defined(__CUDA_ARCH__)
#pragma unroll 4
#endif
  for (int64_t i = tid; i < quads; i += n) {
#if defined(__CUDA_ARCH__)
    const int4 v = __ldg((const int4*)a.table + i);
#else
    struct { int32_t x, y, z, w; } v;
    memcpy(&v, a.table + 4 * i, 16);
#endif
    pairs[2 * i] = ((uint32_t)v.x & 0xffffu) | ((uint32_t)v.y << 16);
    pairs[2 * i + 1] = ((uint32_t)v.z & 0xffffu) | ((uint32_t)v.w << 16);
  }
  for (int64_t i = 4 * quads + tid; i < entries; i += n)
    rows[i] = (uint16_t)ac_ldtab(a.table + i);
  AcDenseTable<uint16_t, Counts> t;
  t.dflat = rows;
  t.nb_out = Counts ? smem : nullptr;
  return t;
}

// Runs the statements with K, a compile-time gram width, the launch's k
// for k = 1-4, else 0 (k read at run time from a.k).
#define AC_WITH_K(k, ...)                                  \
  do {                                                     \
    switch (k) {                                           \
      case 1: { constexpr int K = 1; __VA_ARGS__; } break; \
      case 2: { constexpr int K = 2; __VA_ARGS__; } break; \
      case 3: { constexpr int K = 3; __VA_ARGS__; } break; \
      case 4: { constexpr int K = 4; __VA_ARGS__; } break; \
      default: { constexpr int K = 0; __VA_ARGS__; } break; \
    }                                                      \
  } while (0)

// The raw symbols of one group of G = Syms::kGroup gram steps from gram g0
// (those below j1), loaded ahead of their translation: one load a symbol,
// through the accessor. Groups may start at any gram (first).
template <int K, typename Syms>
struct AcGroup {
  static constexpr int G = Syms::kGroup;
  int32_t v[G][K];

  AC_HD static int64_t first(const Syms&, int64_t j) { return j; }
  AC_HD void load(const Syms& sym, int64_t g0, int64_t j1) {
    AC_UNROLL
    for (int m = 0; m < G; ++m) {
      AC_UNROLL
      for (int i = 0; i < K; ++i)
        v[m][i] = g0 + m < j1 ? sym.load((g0 + m) * K + i) : 0;
    }
  }
  AC_HD int32_t id(const Syms& sym, int64_t g0, int m, int i) const {
    return sym.id((g0 + m) * K + i, v[m][i]);
  }
};

// A stream of bytes at k >= 2: a group's G*K bytes (G*K a multiple of 4,
// so that every group of a sub-stream sits at the same offset in its
// words) as the G*K/4 + 1 aligned 32-bit words that hold them, loaded once
// each where they hold a byte below gram j1, and realigned by funnel
// shifts; a warp's lanes then issue a quarter of the loads that one a byte
// would take. Stream 0's head rows take their ids from head_ids at
// translation.
template <int K>
struct AcGroup<K, AcSyms<uint8_t> > {
  static constexpr int G = kStreamGroup;
  static constexpr int W = G * K / 4;
  uint32_t w[W + 1];
  int sh;

  AC_HD static int64_t first(const AcSyms<uint8_t>&, int64_t j) { return j; }
  AC_HD void load(const AcSyms<uint8_t>& sym, int64_t g0, int64_t j1) {
    const uintptr_t p = (uintptr_t)(sym.row + g0 * K);
    const uint32_t* base = (const uint32_t*)(p & ~(uintptr_t)3);
    sh = (int)(p & 3);
    const int64_t need = g0 < j1 ? (j1 - g0 < G ? j1 - g0 : G) * K + sh : 0;
    AC_UNROLL
    for (int i = 0; i <= W; ++i) w[i] = 4 * i < need ? ac_ldcs(base + i) : 0u;
  }
  AC_HD int32_t id(const AcSyms<uint8_t>& sym, int64_t g0, int m,
                   int i) const {
    const int q = m * K + i;
    const uint32_t u = ac_funnel(w[q >> 2], w[(q >> 2) + 1], sh);
    return sym.id_of_row((g0 + m) * K + i,
                         (int32_t)((u >> (8 * (q & 3))) & 255u));
  }
};

// Sixteen bytes from a 16-byte-aligned address, evict-first.
AC_HD void ac_ldcs16(const void* p, uint32_t w[4]) {
#if defined(__CUDA_ARCH__)
  const uint4 q = __ldcs((const uint4*)p);
  w[0] = q.x;
  w[1] = q.y;
  w[2] = q.z;
  w[3] = q.w;
#else
  memcpy(w, p, 16);
#endif
}

// A stream at k = 1 (K1, K8, and the stepped counts of 1-char tables): a
// group is kVecs 16-byte vectors (16 bytes or 8 int32 symbols) from a
// 16-byte-aligned address, each loaded where it holds a symbol below j1.
// The walk takes the steps before the first aligned symbol one by one
// (first), so every vector is one aligned load: a warp's lanes issue one
// load for 16 bytes of their sub-streams, where a word a load took four.
template <typename T>
struct AcVecGroup {
  static constexpr int kVecs = sizeof(T) == 1 ? 1 : 2;
  static constexpr int kPer = 16 / (int)sizeof(T);   // symbols a vector
  static constexpr int G = kVecs * kPer;
  uint32_t w[4 * kVecs];

  AC_HD static int64_t first(const AcSyms<T>& sym, int64_t j) {
    const uintptr_t p = (uintptr_t)(sym.row + j);
    return j + (int64_t)(((16 - (p & 15)) & 15) / sizeof(T));
  }
  AC_HD void load(const AcSyms<T>& sym, int64_t g0, int64_t j1) {
    AC_UNROLL
    for (int v = 0; v < kVecs; ++v) {
      if (g0 + v * kPer < j1) {
        ac_ldcs16(sym.row + g0 + v * kPer, w + 4 * v);
      } else {
        w[4 * v] = w[4 * v + 1] = w[4 * v + 2] = w[4 * v + 3] = 0u;
      }
    }
  }
  AC_HD int32_t id(const AcSyms<T>& sym, int64_t g0, int m, int) const {
    const int32_t v =
        sizeof(T) == 1 ? (int32_t)((w[m >> 2] >> (8 * (m & 3))) & 255u)
                       : (int32_t)w[m];
    return sym.id_of_row(g0 + m, v);
  }
};

template <>
struct AcGroup<1, AcSyms<uint8_t> > : AcVecGroup<uint8_t> {};
template <>
struct AcGroup<1, AcSyms<int32_t> > : AcVecGroup<int32_t> {};

// The stepped recurrence of one column over gram steps [start, j1) from
// state s (the root unless given), s <- table[s*V^k + gram], handing each
// gram from j0 on to emit(j, s, c): its index, the state after it and its
// count (AcSum sums the counts; K8's AcHitsEmit writes the hits; K4's
// AcEmitWords asks from j0 - 1 on). The table index is 64-bit:
// s*V^k can pass 2^31 where JAX's int32 would wrap. At K > 0 the steps run
// in groups of AcGroup's G, from its first gram on (the steps before it
// one by one): a group's symbols, loaded during the group before, are
// translated and combined into grams first, then the next group's loads
// are issued, then the group's gathers run, so that each step's dependent
// chain is the gather alone (every register index fixed at compile time).
// K = 0 is the plain loop over the run-time k.
template <int K, typename Syms, typename Table, typename Emit>
AC_HD void ac_stepped_walk(const Syms& sym, const Table& table, int32_t V,
                           int32_t k, int64_t Vk, int64_t start, int64_t j0,
                           int64_t j1, Emit& emit, int32_t s = 0) {
  if constexpr (K == 0) {
    for (int64_t j = start; j < j1; ++j) {
      uint32_t c;
      s = table.next((int64_t)s * Vk + ac_gram(sym, j * k, V, k), &c);
      if (j >= j0) emit(j, s, c);
    }
  } else {
    (void)k;
    typedef AcGroup<K, Syms> Group;
    constexpr int G = Group::G;
    const int64_t a0 = Group::first(sym, start);
    int64_t g0 = start;
    for (; g0 < j1 && g0 < a0; ++g0) {
      uint32_t c;
      s = table.next((int64_t)s * Vk + ac_gram(sym, g0 * K, V, K), &c);
      if (g0 >= j0) emit(g0, s, c);
    }
    Group nxt;
    nxt.load(sym, g0, j1);
    for (; g0 < j1; g0 += G) {
      uint32_t gram[G];
      AC_UNROLL
      for (int m = 0; m < G; ++m) {
        uint32_t g = 0;
        AC_UNROLL
        for (int i = 0; i < K; ++i)
          g = g * (uint32_t)V + (uint32_t)nxt.id(sym, g0, m, i);
        gram[m] = g;
      }
      nxt.load(sym, g0 + G, j1);
      AC_UNROLL
      for (int m = 0; m < G; ++m) {
        const int64_t j = g0 + m;
        if (j >= j1) break;
        uint32_t c;
        s = table.next((int64_t)s * Vk + gram[m], &c);
        if (j >= j0) emit(j, s, c);
      }
    }
  }
}

// The count hook: the grams' counts summed in uint32 (wrapping like JAX's
// int32 accumulator).
struct AcSum {
  uint32_t tot = 0;
  AC_HD void operator()(int64_t, int32_t, uint32_t c) { tot += c; }
};

// Sub-streams per column: a power of two up to AC_MAX_SPLIT. The
// launchers of the batch forms (K5, K9's batch) pick a P above
// AC_COLS_SPLIT only where its launch fits one wave: a column's
// sub-streams share a block, and above 8 of them the block's 1,024
// threads hold the kernel to 64 registers, where it spills at k >= 2, so
// such a split pays only for a few long columns (PERF.md).
#define AC_MAX_SPLIT 32
#define AC_SPLITS 6   // P = 1, 2, 4, ..., AC_MAX_SPLIT
#define AC_COLS_SPLIT 8

// The P of the last split launch of a library (K1, K3, K5, K8, K9, K11), read
// through its ac_last_split() to report it.
inline int g_ac_last_split = 0;

// Bytes the 1-char tables of the last stream-form launch (K1, K2, K7 dense,
// K8) took in shared memory; 0 where they stayed in device memory (forced,
// past 65,536 states, or too large for a block). Read through
// ac_last_dense_table().
inline int64_t g_ac_last_dense_table = 0;

AC_HD bool ac_valid_split(int P) {
  return P >= 1 && P <= AC_MAX_SPLIT && (P & (P - 1)) == 0;
}

// Sub-stream p of P of a column of halo_steps = a.halo / K halo grams and
// n_body = a.L / K body grams: it emits body grams [j0, j1), j0 = halo_steps
// + n_body*p/P, j1 = halo_steps + n_body*(p+1)/P (the last takes the
// remainder). Sub-stream 0 runs from gram 0 as the one-thread body does;
// sub-stream p > 0 starts from the root warm_steps grams before j0, or at
// gram 0 where that is closer. warm_steps*k >= max_depth - 1 symbols read
// from the root put every state from j0's first symbol on at the longest
// suffix of the column's rows that is a trie node, as the column's run
// from gram 0 does (ops/blocking.py's halo argument, inside the column), so
// the P parts emit what the one-thread run does, states included,
// whatever the halo.
//
// ac_part_range gives a sub-stream's [j0, j1) and the gram it starts at;
// false for an empty part past the first.
AC_HD bool ac_part_range(const AcScanArgs& a, int64_t k, int p, int P,
                         int64_t* start, int64_t* j0, int64_t* j1) {
  const int64_t hs = a.halo / k, n_body = a.L / k;
  *j0 = hs + n_body * p / P;
  *j1 = hs + n_body * (p + 1) / P;
  if (p > 0 && *j0 >= *j1) return false;
  *start = p == 0 ? 0 : (*j0 > a.warm_steps ? *j0 - a.warm_steps : 0);
  return true;
}

template <int K, typename Syms, typename Table, typename Emit>
AC_HD void ac_stepped_part_walk(const AcScanArgs& a, const Syms& sym,
                                const Table& table, int p, int P,
                                Emit& emit) {
  const int64_t k = K ? K : a.k;
  int64_t start, j0, j1;
  if (ac_part_range(a, k, p, P, &start, &j0, &j1))
    ac_stepped_walk<K>(sym, table, a.V, (int32_t)k, a.Vk, start, j0, j1,
                       emit);
}

// The count of sub-stream p of P.
template <int K, typename Syms, typename Table>
AC_HD uint32_t ac_stepped_part(const AcScanArgs& a, const Syms& sym,
                               const Table& table, int p, int P) {
  AcSum sum;
  ac_stepped_part_walk<K>(a, sym, table, p, P, sum);
  return sum.tot;
}

// K3 (ops/multistep.py:stepped_count_core), K9's stream form and K11's
// gather half, one warp: columns [0, n_cols), P sub-streams each in
// consecutive lanes; lane l is sub-stream (g0 + l) % P of column
// (g0 + l) / P. The P totals of a column reduce in uint32 (wrapping like
// JAX's int32 accumulator) by __shfl_xor_sync and the column's first lane
// writes it once. Lanes past the last column take part with a zero total:
// every lane reaches every shuffle.
//
// ac_lanes_sum leaves in every lane the uint32 sum of v over its group of
// P consecutive lanes (P a power of two), by __shfl_xor_sync butterflies.
AC_HD void ac_lanes_sum(uint32_t v[AC_LANE_SLOTS], int P, int lane) {
  (void)lane;  // the host runs every lane
  uint32_t x[AC_LANE_SLOTS];
  for (int m = P >> 1; m > 0; m >>= 1) {
    ac_shfl_xor(v, x, m);
    AC_FOR_LANES(l, lane) { v[AC_SLOT(l)] += x[AC_SLOT(l)]; }
  }
}

template <int K, typename Layout, typename Table>
AC_HD void ac_stepped_lanes(const AcScanArgs& a, const Table& table,
                            int64_t n_cols, int P, int64_t g0, int lane) {
  (void)lane;  // the host runs every lane
  uint32_t tot[AC_LANE_SLOTS];
  AC_FOR_LANES(l, lane) {
    const int64_t g = g0 + l, col = g / P;
    tot[AC_SLOT(l)] =
        col < n_cols ? ac_stepped_part<K>(a, Layout::make(a, col), table,
                                          (int)(g % P), P)
                     : 0u;
  }
  ac_lanes_sum(tot, P, lane);
  AC_FOR_LANES(l, lane) {
    const int64_t g = g0 + l;
    if (g % P == 0 && g / P < n_cols) a.out[g / P] = (int32_t)tot[AC_SLOT(l)];
  }
}

// The sum of column col's P sub-streams, one after another: what K5's and
// K9's batch-form block computes for the column (there the sub-streams run
// in P warps and reduce through shared memory), for the host build.
template <int K, typename Layout, typename Table>
AC_HD uint32_t ac_stepped_column(const AcScanArgs& a, const Table& table,
                                 int64_t col, int P) {
  const typename Layout::Syms sym = Layout::make(a, col);
  uint32_t tot = 0;
  for (int p = 0; p < P; ++p) tot += ac_stepped_part<K>(a, sym, table, p, P);
  return tot;
}

// Sixteen bytes to a 16-byte-aligned address, streaming (written once).
AC_HD void ac_stcs16(void* p, const int32_t w[4]) {
#if defined(__CUDA_ARCH__)
  __stcs((int4*)p, make_int4(w[0], w[1], w[2], w[3]));
#else
  memcpy(p, w, 16);
#endif
}

// Hits a K8 thread stages before it writes them: one 32-byte sector of
// positions and one of states.
constexpr int kHitStage = 8;

// K8's hooks: a body row hits where its state's count is non-zero.
// Pass 1: the matches and the hit positions, counted.
struct AcHitsCount {
  uint32_t hits = 0;
  int32_t n_pos = 0;

  AC_HD void operator()(int64_t, int32_t, uint32_t c) {
    hits += c;
    n_pos += c != 0;
  }
};

// Pass 2: each hit's position (base + row) and state, from slot on. With
// a stage, the hits are staged: entry k's position at stage[k*stride], its
// state at stage[(kHitStage + k)*stride] (shared memory on the card, the
// block's threads interleaved, so that a warp's lanes never share a
// bank), and the kHitStage hits of each kHitStage-aligned run of slots go
// out as two 16-byte stores an array, whole sectors; those of a run
// covered only in part (the first and the last) one by one. Without one
// (stage null) each hit is written as it comes.
struct AcHitsEmit {
  int32_t* pos;
  int32_t* state;
  int32_t* stage;
  int stride, staged = 0;
  int64_t slot, base;

  AC_HD void operator()(int64_t j, int32_t s, uint32_t c) {
    if (c == 0) return;
    if (stage == nullptr) {
      pos[slot] = (int32_t)(base + j);
      state[slot] = s;
      ++slot;
      return;
    }
    stage[staged * stride] = (int32_t)(base + j);
    stage[(kHitStage + staged) * stride] = s;
    ++staged;
    ++slot;
    if (slot % kHitStage == 0) flush();
  }
  // The staged hits, slots [slot - staged, slot), to the outputs.
  AC_HD void flush() {
    const int64_t s0 = slot - staged;
    if (staged == kHitStage && ((uintptr_t)(pos + s0) & 15) == 0 &&
        ((uintptr_t)(state + s0) & 15) == 0) {
      int32_t w[2 * kHitStage];
      AC_UNROLL
      for (int k = 0; k < 2 * kHitStage; ++k) w[k] = stage[k * stride];
      ac_stcs16(pos + s0, w);
      ac_stcs16(pos + s0 + 4, w + 4);
      ac_stcs16(state + s0, w + kHitStage);
      ac_stcs16(state + s0 + 4, w + kHitStage + 4);
    } else {
      for (int k = 0; k < staged; ++k) {
        pos[s0 + k] = stage[k * stride];
        state[s0 + k] = stage[(kHitStage + k) * stride];
      }
    }
    staged = 0;
  }
};

// K8 (ops/hits.py:make_blocked_hits, ops/sparse.py:_window_hits_core),
// sub-stream g of the launch: sub-stream g % P of column g / P, the 1-char
// recurrence over AcDenseTable. Pass 1 (Write false) writes its matches
// to n_hits[g] and its hit positions to n_live[g]; pass 2 (Write), at the
// same P, re-runs it and writes (position, state) of each hit from slot
// hit_off[g] on, staged in 2 * kHitStage words from stage on, stride
// apart, where stage is not null (AcHitsEmit). A column's sub-streams
// cover consecutive rows, so slots from the exclusive prefix sum of pass
// 1's n_live over g hold the hits in stream order, exactly as many as
// there are. Row t of column c is at position Layout::pos0(a, c) + t -
// halo.
template <bool Write, typename Layout, typename Table>
AC_HD void ac_dense_hits_sub(const AcScanArgs& a, const Table& table,
                             int64_t g, int P, int32_t* stage, int stride) {
  const int64_t col = g / P;
  const typename Layout::Syms sym = Layout::make(a, col);
  if constexpr (Write) {
    AcHitsEmit e;
    e.pos = a.hit_pos;
    e.state = a.hit_state;
    e.stage = stage;
    e.stride = stride;
    e.slot = a.hit_off[g];
    e.base = Layout::pos0(a, col) - a.halo;
    ac_stepped_part_walk<1>(a, sym, table, (int)(g % P), P, e);
    if (stage != nullptr) e.flush();
  } else {
    (void)stage;
    (void)stride;
    AcHitsCount e;
    ac_stepped_part_walk<1>(a, sym, table, (int)(g % P), P, e);
    a.n_hits[g] = (int32_t)e.hits;
    a.n_live[g] = e.n_pos;
  }
}

// States a K2 thread stages before it writes them: one 32-byte sector.
constexpr int kStateStage = 8;

// K2's stream hook: the state after body row j at out[base + j], staged:
// entry k at stage[k*stride] (shared memory on the card, the block's
// threads interleaved, so that a warp's lanes never share a bank), and the
// kStateStage states of each kStateStage-aligned run of out go out as two
// 16-byte stores, a whole sector; those of a run covered only in part (a
// sub-stream's first and last) one by one. A warp's lanes write 32
// separate runs, so one state a store would touch 32 sectors for 4 bytes
// each.
struct AcStatesEmit {
  int32_t* out;
  int32_t* stage;
  int stride, staged = 0;
  int64_t base, end = 0;   // end: one past the last staged state's index

  AC_HD void operator()(int64_t j, int32_t s, uint32_t) {
    stage[staged * stride] = s;
    ++staged;
    end = base + j + 1;
    if ((end & (kStateStage - 1)) == 0) flush();
  }
  // The staged states, out[end - staged, end), to the output.
  AC_HD void flush() {
    const int64_t s0 = end - staged;
    if (staged == kStateStage && ((uintptr_t)(out + s0) & 15) == 0) {
      int32_t w[kStateStage];
      AC_UNROLL
      for (int k = 0; k < kStateStage; ++k) w[k] = stage[k * stride];
      ac_stcs16(out + s0, w);
      ac_stcs16(out + s0 + 4, w + 4);
    } else {
      for (int k = 0; k < staged; ++k) out[s0 + k] = stage[k * stride];
    }
    staged = 0;
  }
};

// K2 (ops/scan_xla.py:make_blocked_scan_stream / _raw), sub-stream g of
// the launch: sub-stream g % P of stream g / P, the 1-char recurrence over
// AcDenseTable without counts, writing the state after each of its body
// rows, [j0 - halo, j1 - halo) of the stream's L, through AcStatesEmit
// (kStateStage words from stage on, stride apart). From its first body
// symbol on, a warmed-up sub-stream's states are the one-thread run's
// (ac_stepped_part_walk), so the P parts write what it does.
template <typename Layout, typename Table>
AC_HD void ac_dense_states_sub(const AcScanArgs& a, const Table& table,
                               int64_t g, int P, int32_t* stage,
                               int stride) {
  const int64_t col = g / P;
  AcStatesEmit e;
  e.out = a.out;
  e.stage = stage;
  e.stride = stride;
  e.base = col * a.L - a.halo;
  ac_stepped_part_walk<1>(a, Layout::make(a, col), table, (int)(g % P), P,
                          e);
  e.flush();
}

// K2's time-major hook (ops/scan_xla.py:make_blocked_scan): the state
// after body row j of a batch column at out[(j - hs) * stride], out at
// the column's first row; a warp's 32 neighbouring columns write one
// 128-byte row.
struct AcColStates {
  int32_t* out;
  int64_t stride, hs;

  AC_HD void operator()(int64_t j, int32_t s, uint32_t) {
    out[(j - hs) * stride] = s;
  }
};

// K2's time-major column col (halo 0 in make_blocked_scan), its
// sub-stream p of P.
template <typename Layout, typename Table>
AC_HD void ac_col_states_part(const AcScanArgs& a, const Table& table,
                              const typename Layout::Syms& sym, int64_t col,
                              int p, int P) {
  AcColStates e;
  e.out = a.out + col;
  e.stride = a.B;
  e.hs = a.halo;
  ac_stepped_part_walk<1>(a, sym, table, p, P, e);
}

// K2's one-chain form: a launch of one stream kept at P = 1
// (make_sequential_scan through scan_states_sequential, the conformance
// oracle of the split scans, forces it; any stream launch of B = 1 whose
// launcher picks one sub-stream takes it too). Its window rows run in
// chunks of kSeqChunk: on the card one thread walks a chunk over letter
// ids in shared memory, writing its states there, while the block's other
// warps translate the next chunk's symbols into ids and write the last
// chunk's states out (a warp's stores one 128-byte row), so the chain is
// the table gather alone; its tables on the SM where they fit. The host
// runs the chunks in turn.
constexpr int kSeqChunk = 2048;

// Rows [t0, t0 + n) of stream 0's window as letter ids, ids[k] for row
// t0 + k, by thread tid of nth.
template <typename T>
AC_HD void ac_seq_load(const AcSyms<T>& sym, int64_t t0, int n,
                       int32_t* ids, int tid, int nth) {
  for (int k = tid; k < n; k += nth) ids[k] = sym(t0 + k);
}

// The chain over n ids from state s: with Store, st[k] the state after
// ids[k]; returns the last. On the SM the index is 32-bit arithmetic, one
// multiply-add on the chain.
template <typename Table, bool Store = true>
AC_HD int32_t ac_seq_walk(const Table& table, int32_t V, const int32_t* ids,
                          int32_t* st, int n, int32_t s) {
#if defined(__CUDA_ARCH__)
#pragma unroll 8
#endif
  for (int k = 0; k < n; ++k) {
    uint32_t c;
    const int64_t i =
        Table::kOnSm ? (int64_t)((uint32_t)s * (uint32_t)V + (uint32_t)ids[k])
                     : (int64_t)s * V + ids[k];
    s = table.next(i, &c);
    if constexpr (Store) st[k] = s;
  }
  return s;
}

// The states st of rows [t0, t0 + n) to out, those past the halo (row t
// at out[t - halo]), by thread tid of nth.
AC_HD void ac_seq_store(const AcScanArgs& a, int64_t t0, int n,
                        const int32_t* st, int tid, int nth) {
  for (int k = tid; k < n; k += nth)
    if (t0 + k >= a.halo) a.out[t0 + k - a.halo] = st[k];
}

// The launcher's P for n_cols columns of n_body body grams, halo_steps halo
// grams and warm_steps of warm-up, from slots[i], the threads the card
// holds at once (SMs x resident blocks x block size) at P = 2^i: the P
// whose longest sub-stream, times the waves of threads its launch needs,
// is the least (the smaller P on a tie), among those whose sub-streams'
// bodies each hold at least 4 * warm_steps grams and one, and, above
// wide_split, whose launch fits one wave. A latency-bound chain takes
// about its length per wave, so this is the launch's critical path in
// dependent gathers; P = 1 is the one-thread launch.
inline int ac_pick_split(int64_t n_cols, int64_t n_body, int64_t halo_steps,
                         int64_t warm_steps, const int64_t* slots,
                         int wide_split) {
  int best = 1;
  int64_t best_cost = -1;
  for (int i = 0, P = 1; i < AC_SPLITS; ++i, P *= 2) {
    if (P > 1 && (n_body / P < 4 * warm_steps || n_body / P < 1)) break;
    const int64_t waves =
        slots[i] > 0 ? (n_cols * P + slots[i] - 1) / slots[i] : 1;
    if (P > wide_split && waves > 1) continue;
    const int64_t lead = P > 1 && warm_steps > halo_steps ? warm_steps
                                                          : halo_steps;
    const int64_t cost = waves * ((n_body + P - 1) / P + lead);
    if (best_cost < 0 || cost < best_cost) {
      best = P;
      best_cost = cost;
    }
  }
  return best;
}

// The P of a launch over n_cols columns: its split field where set, else
// ac_pick_split over slots (1 without columns); kept as the library's last
// split. 0, which fails the launch, for a split that is no power of two up
// to AC_MAX_SPLIT and for columns without warm_steps (negative, as
// ops/build.py:scan_args leaves it), which would count wrong once P > 1
// (K11's MMA half alone, B1 = 0, has no such column).
inline int ac_launch_split(const AcScanArgs& a, int64_t n_cols,
                           const int64_t* slots, int wide_split) {
  int P = 1;
  if (n_cols > 0 && a.warm_steps < 0)
    P = 0;
  else if (a.split != 0)
    P = ac_valid_split(a.split) ? a.split : 0;
  else if (n_cols > 0)
    P = ac_pick_split(n_cols, a.L / a.k, a.halo / a.k, a.warm_steps, slots,
                      wide_split);
  if (P > 0) g_ac_last_split = P;
  return P;
}

// The one-thread stepped count of a column (K7's windows): sub-stream 0
// of 1.
template <typename Syms, typename Table>
AC_HD int32_t ac_stepped_count_body(const AcScanArgs& a, const Syms& sym,
                                    const Table& table) {
  AC_WITH_K(a.k, return (int32_t)ac_stepped_part<K>(a, sym, table, 0, 1));
  return 0;
}

// K7 stepped (ops/sparse.py:make_sparse_count_stepped / _dev, and the
// elided stepped count): K3's recurrence over one live-block window.
AC_HD void ac_sparse_count_stepped_column(const AcScanArgs& a,
                                          int64_t column) {
  a.out[column] = ac_stepped_count_body(a, ac_win_syms(a, column),
                                        ac_packed(a));
}

// K4's hook (ops/hits.py:_stepped_emit_scan): for each body gram j from
// j0 on, the word (pre << count_bits) | c, pre the state before the gram,
// at out[base + j] through AcStatesEmit (whole sectors), and the
// sub-stream's matches and live grams (those with a match) summed. The walk
// hands it gram j0 - 1 too, whose state is gram j0's pre-state; where the
// walk starts at j0 (a column's start) pre stays the root, as in the
// one-thread run.
struct AcEmitWords {
  AcStatesEmit words;
  int64_t j0;
  int count_bits;
  int32_t pre = 0;
  uint32_t hits = 0, live = 0;

  AC_HD void operator()(int64_t j, int32_t s, uint32_t c) {
    if (j >= j0) {
      words(j, (int32_t)(((uint32_t)pre << count_bits) | c), c);
      hits += c;
      live += c != 0u;
    }
    pre = s;
  }
};

// K4 (make_stepped_hits_scan / _raw), one warp, as K3's lanes: sub-stream
// g % P of stream g / P in lane g - g0, writing its body grams' words at
// out[b*n_body + j - halo_steps] (stream-major [B, L/k], so every
// sub-stream writes its own slots in one pass), staged kStateStage words
// from stage + lane on, stride apart (the host's lanes; on the card stage
// is the thread's own). Its warm-up, warm_steps = ceil(max_depth / k)
// grams, is one symbol longer than the counts': the state before j0 may be
// a longest keyword's end, max_depth deep, which a walk of max_depth - 1
// symbols from the root cannot reach. The P partial n_hits (wrapping in
// uint32 like JAX's int32 sum) and n_live reduce by warp shuffles and the
// stream's first lane writes them.
template <int K, typename Layout, typename Table>
AC_HD void ac_stepped_emit_lanes(const AcScanArgs& a, const Table& table,
                                 int P, int64_t g0, int lane,
                                 int32_t* stage, int stride) {
  (void)lane;  // the host runs every lane
  const int64_t k = K ? K : a.k;
  const int64_t hs = a.halo / k, n_body = a.L / k;
  uint32_t hits[AC_LANE_SLOTS], live[AC_LANE_SLOTS];
  AC_FOR_LANES(l, lane) {
    const int64_t g = g0 + l, col = g / P;
    AcEmitWords e;
    e.words.out = a.out;
    e.words.stage = stage + AC_SLOT(l);
    e.words.stride = stride;
    e.words.base = col * n_body - hs;
    e.count_bits = a.count_bits;
    int64_t start, j0, j1;
    if (col < a.B && ac_part_range(a, k, (int)(g % P), P, &start, &j0, &j1)) {
      e.j0 = j0;
      ac_stepped_walk<K>(Layout::make(a, col), table, a.V, (int32_t)k, a.Vk,
                         start, j0 - 1, j1, e);
      e.words.flush();
    }
    hits[AC_SLOT(l)] = e.hits;
    live[AC_SLOT(l)] = e.live;
  }
  ac_lanes_sum(hits, P, lane);
  ac_lanes_sum(live, P, lane);
  AC_FOR_LANES(l, lane) {
    const int64_t g = g0 + l;
    if (g % P == 0 && g / P < a.B) {
      a.n_hits[g / P] = (int32_t)hits[AC_SLOT(l)];
      a.n_live[g / P] = (int32_t)live[AC_SLOT(l)];
    }
  }
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
  // position of body row 0 of column c (K8)
  AC_HD static int64_t pos0(const AcScanArgs& a, int64_t c) {
    return c * a.L;
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
  AC_HD static int64_t pos0(const AcScanArgs& a, int64_t c) {
    return (int64_t)a.idx[c] * a.L;
  }
};

// K7 dense's index-list form (gather, row_stride 1): window c is the
// contiguous rows ext[idx[c]*col_stride + t] of the stream's ids, so it
// takes the stream accessor, whose sub-streams load their symbols a group
// ahead as aligned 16-byte vectors (AcVecGroup); at L_blk = 128 a window
// starts 512-byte aligned.
struct AcWinRowsLayout {
  typedef AcSyms<int32_t> Syms;
  AC_HD static Syms make(const AcScanArgs& a, int64_t c) {
    Syms s;
    s.row = (const int32_t*)a.ext + (int64_t)a.idx[c] * a.col_stride;
    s.lut = nullptr;
    s.head = nullptr;
    s.n_lut = 0;
    s.halo = a.halo;
    return s;
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
// after every symbol from the root, by composition of the symbols'
// transition functions f_c = delta[:, c] (an [S] vector each). The ids are
// cut into B chunks of L and the chunks into tiles of G (a.tile), and
// every phase is short chains over many threads:
// (1) chunk c's function F_c at state s, for every (c, s): T*S lookups in
//     all, by design of the formulation, each a chain of L (ac_assoc_compose);
// (2) tile i's function H_i = F_last o ... o F_first at every s, a chain
//     of G through its chunks' rows of F (ac_assoc_tile);
// (3) each chunk's start: tiles [0, i) applied to the root (a chain of at
//     most n_tiles through H), then chunks [i*G, c) of its tile (at most G
//     through F); the chunk re-run from there, writing its states
//     (ac_assoc_states).
// The functions are exact, so the start states are, for any automaton,
// with no warm-up. compose holds F [B, S] then H [n_tiles, S]; the
// functions read on the SM or in place, delta through AcDenseTable (its
// rows on the SM as uint16 where they fit, else the read-only path).

// The ids of chunk c: [c*L, min((c + 1)*L, T)).
AC_HD int64_t ac_assoc_len(const AcScanArgs& a, int64_t c) {
  const int64_t t0 = c * a.L;
  return t0 + a.L < a.doc_len ? a.L : a.doc_len - t0;
}

// The chunks of tile i.
AC_HD int64_t ac_assoc_tile_len(const AcScanArgs& a, int64_t i) {
  const int64_t c0 = i * a.tile;
  return c0 + a.tile < a.B ? a.tile : a.B - c0;
}

// fns[n - 1] o ... o fns[0] at s, the functions rows of S entries.
AC_HD int32_t ac_assoc_apply(const int32_t* fns, int32_t S, int64_t n,
                             int32_t s) {
  for (int64_t i = 0; i < n; ++i) s = fns[i * S + s];
  return s;
}

// (1) F_c[s] over chunk c's ids (on the card staged on the SM).
template <typename Table>
AC_HD void ac_assoc_compose(const AcScanArgs& a, const Table& table,
                            const int32_t* ids, int64_t c, int32_t s) {
  a.compose[c * a.n_states + s] = ac_seq_walk<Table, false>(
      table, a.V, ids, nullptr, (int)ac_assoc_len(a, c), s);
}

// (2) H_i[s] over tile i's rows of F, fns (on the SM or in place).
AC_HD void ac_assoc_tile(const AcScanArgs& a, const int32_t* fns, int64_t i,
                         int32_t s) {
  a.compose[(a.B + i) * a.n_states + s] =
      ac_assoc_apply(fns, a.n_states, ac_assoc_tile_len(a, i), s);
}

// (3) Chunk c from its start state s: starts[c] = s, and its states to
// out through AcStatesEmit (kStateStage words from stage on, stride apart),
// K2's walk at k = 1 (its ids as aligned 16-byte vectors, a group ahead).
template <typename Table>
AC_HD void ac_assoc_states(const AcScanArgs& a, const Table& table,
                           int64_t c, int32_t s, int32_t* stage,
                           int stride) {
  a.starts[c] = s;
  AcSyms<int32_t> sym;
  sym.row = (const int32_t*)a.ext;
  sym.lut = nullptr;
  sym.head = nullptr;
  sym.n_lut = 0;
  sym.halo = 0;
  AcStatesEmit e;
  e.out = a.out;
  e.stage = stage;
  e.stride = stride;
  e.base = 0;
  const int64_t t0 = c * a.L;
  ac_stepped_walk<1>(sym, table, a.V, 1, a.V, t0, t0,
                     t0 + ac_assoc_len(a, c), e, s);
  e.flush();
}

// A launch's geometry is valid: tiles of 1 to kAssocMaxTile chunks (a
// block's threads in phase 3) and chunks of 1 to kAssocMaxChunk ids (a
// block's staged ids in phase 1).
constexpr int kAssocMaxTile = 1024;
constexpr int64_t kAssocMaxChunk = 16384;

AC_HD bool ac_assoc_valid(const AcScanArgs& a) {
  return a.tile >= 1 && a.tile <= kAssocMaxTile && a.L >= 1 &&
         a.L <= kAssocMaxChunk && a.n_states >= 1;
}

#if defined(__CUDACC__)
// ---------------------------------------------------------------------------
// What the CUDA launchers share (dense_scan.cu, stepped_scan.cu,
// sparse_scan.cu, mxu_scan.cu).
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#define AC_TRY(x)                          \
  do {                                     \
    const cudaError_t e_ = (x);            \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

// The LUT into shared memory (lut_n > 0 entries), by every thread of the
// block; the block then reads it there.
__device__ __forceinline__ void ac_lut_to_smem(AcScanArgs& a, int32_t lut_n,
                                               int32_t* smem) {
  if (lut_n > 0) {
    for (int i = threadIdx.x; i < lut_n; i += blockDim.x) smem[i] = a.lut[i];
    __syncthreads();
    a.lut = smem;
  }
}

// The card's SM count and shared memory limits (a block's opt-in maximum
// and an SM's), queried once per device: the launchers plan every call.
struct AcDevice {
  int sms = 0, optin = 0, per_sm = 0;
};

inline cudaError_t ac_device(AcDevice* d) {
  static std::mutex mu;
  static std::map<int, AcDevice> cache;
  int dev = 0;
  AC_TRY(cudaGetDevice(&dev));
  std::lock_guard<std::mutex> hold(mu);
  const auto it = cache.find(dev);
  if (it != cache.end()) {
    *d = it->second;
    return cudaSuccess;
  }
  AC_TRY(cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount,
                                dev));
  AC_TRY(cudaDeviceGetAttribute(
      &d->optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  AC_TRY(cudaDeviceGetAttribute(
      &d->per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev));
  cache[dev] = *d;
  return cudaSuccess;
}

// A kernel's dynamic shared memory limit raised to `bytes` where that
// passes 48 KB and what it was raised to on this device before: per kernel
// and device, only ever raised, so that every size planned before stays
// allowed, and set once, not each call.
inline cudaError_t ac_allow_smem(const void* kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int64_t> raised;
  int dev = 0;
  AC_TRY(cudaGetDevice(&dev));
  std::lock_guard<std::mutex> hold(mu);
  int64_t& set = raised[std::make_pair(kernel, dev)];
  if (bytes > set) {
    AC_TRY(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
    set = bytes;
  }
  return cudaSuccess;
}

// A kernel's resident blocks an SM at a block size and dynamic shared
// memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), queried once per
// kernel, device and sizes: a run launches a kernel many times at the same
// sizes. A size above 48 KB needs ac_allow_smem first.
struct AcOccupancy {
  int sms = 0, blocks = 0;
};

inline cudaError_t ac_occupancy(const void* kernel, int threads,
                                int64_t smem, AcOccupancy* occ) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int64_t>, AcOccupancy>
      cache;
  int dev = 0;
  AC_TRY(cudaGetDevice(&dev));
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  std::lock_guard<std::mutex> hold(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *occ = it->second;
    return cudaSuccess;
  }
  AcDevice d;
  AC_TRY(ac_device(&d));
  occ->sms = d.sms;
  AC_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ->blocks, kernel,
                                                       threads, smem));
  cache[key] = *occ;
  return cudaSuccess;
}

// The threads the card holds at once of a kernel (SMs x resident blocks x
// block size): what ac_pick_split weighs a launch's waves against.
template <typename Kernel>
cudaError_t ac_slots(Kernel kernel, int threads, int64_t smem,
                     int64_t* slots) {
  AcOccupancy occ;
  AC_TRY(ac_occupancy((const void*)kernel, threads, smem, &occ));
  *slots = (int64_t)occ.sms * occ.blocks * threads;
  return cudaSuccess;
}

// The 1-char launches of the stream forms (K1, K2, K8). A kernel of this
// type reads the LUT's lut_n entries from shared memory, the 1-char tables
// from the tab_words words behind them (staged once a block:
// ac_dense_sm_table) or through the read-only path, and runs the launch's
// B*P sub-streams over a grid of at most one wave, each block looping over
// them; K8's pass 2 (on the SM) and K2 (on both paths) stage their outputs
// in the shared memory after the tables (AcDenseStage).
typedef void (*AcDenseKernel)(AcScanArgs, int32_t P, int32_t lut_n,
                              int32_t tab_words);

// The block's copy of the 1-char tables (ac_dense_stage), once every
// thread has taken part.
template <bool Counts = true>
__device__ __forceinline__ AcDenseTable<uint16_t, Counts> ac_dense_sm_table(
    const AcScanArgs& a, int32_t* smem) {
  const AcDenseTable<uint16_t, Counts> t =
      ac_dense_stage<Counts>(a, smem, threadIdx.x, blockDim.x);
  __syncthreads();
  return t;
}

// The bytes of the 1-char tables on the SM beside `beside` bytes of the
// block's other shared memory (ac_dense_smem_bytes, within the card's
// opt-in limit), or 0: they stay in device memory.
inline cudaError_t ac_dense_tab(const AcScanArgs& a, int64_t beside,
                                int64_t* tab) {
  AcDevice d;
  AC_TRY(ac_device(&d));
  *tab = ac_dense_smem_bytes(a, beside);
  if (beside + *tab > d.optin) *tab = 0;
  return cudaSuccess;
}

// A block of `threads` with `used` bytes of dynamic shared memory: its
// request (*smem) and occupancy. Padded (pad), one block an SM: the
// request passes half the SM's shared memory, so that the rest of its
// 256 KB stays L1 for the stream's symbols (two blocks of the slice's
// 110 KB would leave it 28 KB, and an int32 stream then ran slower than
// through the read-only path).
inline cudaError_t ac_dense_block(const void* kernel, int threads,
                                  int64_t used, bool pad, int64_t* smem,
                                  AcOccupancy* occ) {
  *smem = used;
  if (pad) {
    AcDevice d;
    AC_TRY(ac_device(&d));
    if (*smem <= d.per_sm / 2) *smem = d.per_sm / 2 + 1;
  }
  AC_TRY(ac_allow_smem(kernel, *smem));
  AC_TRY(ac_occupancy(kernel, threads, *smem, occ));
  return occ->blocks < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The shared-memory words a thread that a stream-form kernel pair stages
// its outputs in: `fit` beside the tables when deciding whether they go on
// the SM (K8's two passes both reserve pass 2's, so that they take the
// same path), `on_sm` and `global` what each kernel of the pair is given
// (K8's pass 2 stages on the SM only: a global block keeps its L1 for the
// tables; K2 on both, its states being its traffic); `pad`, whether the
// SM path holds one block an SM (ac_dense_block: K1, K2, K8; K7 dense's
// windows, whose tables are a few KB at the hunt, ran faster unpadded).
struct AcDenseStage {
  int fit, on_sm, global;
  bool pad = true;
};

// A stream-form launch, planned (ac_dense_plan) and then run
// (ac_dense_run).
struct AcDensePlan {
  AcScanArgs a;
  AcDenseKernel kernel;
  int threads;
  int64_t smem, grid;
  int32_t P, lut_n, tab_words;
};

// Plan a stream-form 1-char launch over a's B columns, P sub-streams
// each: on_sm where the tables fit on the SM beside the LUT and
// stage.fit words a thread (ac_dense_tab), blocks of kDenseSmThreads
// (one an SM where stage.pad), else global. P is the launch's split
// field where set, else ac_pick_split over the kernel's occupancy; the
// grid is at most one wave.
inline cudaError_t ac_dense_plan(const AcScanArgs& args, AcDenseKernel on_sm,
                                 AcDenseKernel global, AcDenseStage stage,
                                 AcDensePlan* plan) {
  AcDensePlan& p = *plan;
  p.a = ac_dense_args(args);
  p.lut_n = ac_lut_entries(p.a);
  int64_t tab = 0;
  AC_TRY(ac_dense_tab(
      p.a, 4 * ((int64_t)p.lut_n + (int64_t)stage.fit * kDenseSmThreads),
      &tab));
  p.tab_words = (int32_t)(tab / 4);
  g_ac_last_dense_table = tab;
  p.kernel = tab > 0 ? on_sm : global;
  p.threads = tab > 0 ? kDenseSmThreads : kDenseThreads;
  const int words = tab > 0 ? stage.on_sm : stage.global;
  AcOccupancy occ;
  AC_TRY(ac_dense_block(
      (const void*)p.kernel, p.threads,
      4 * ((int64_t)p.lut_n + (int64_t)words * p.threads) + tab,
      tab > 0 && stage.pad, &p.smem, &occ));
  int64_t slots[AC_SPLITS];
  for (int i = 0; i < AC_SPLITS; ++i)
    slots[i] = (int64_t)occ.sms * occ.blocks * p.threads;
  p.P = ac_launch_split(p.a, p.a.B, slots, AC_MAX_SPLIT);
  if (p.P == 0) return cudaErrorInvalidValue;
  const int64_t need = ((int64_t)p.a.B * p.P + p.threads - 1) / p.threads;
  const int64_t wave = (int64_t)occ.sms * occ.blocks;
  p.grid = need < wave ? need : wave;
  return cudaSuccess;
}

inline cudaError_t ac_dense_run(const AcDensePlan& p, cudaStream_t st) {
  if (p.grid == 0) return cudaSuccess;
  p.kernel<<<(unsigned)p.grid, p.threads, p.smem, st>>>(p.a, p.P, p.lut_n,
                                                        p.tab_words);
  return cudaGetLastError();
}

inline cudaError_t ac_dense_launch(const AcScanArgs& args,
                                   AcDenseKernel on_sm, AcDenseKernel global,
                                   AcDenseStage stage, cudaStream_t st) {
  AcDensePlan p;
  AC_TRY(ac_dense_plan(args, on_sm, global, stage, &p));
  return ac_dense_run(p, st);
}

namespace {

// K1 and K7 dense: each warp of the grid's loop takes 32 of the launch's
// B*P sub-streams (ac_stepped_lanes at k = 1) over Layout's columns (K1's
// streams, K7's windows); the loop's bound is the same in every lane of a
// warp, so every lane reaches every shuffle.
template <typename Layout, typename Table>
__device__ __forceinline__ void ac_dense_count_lanes(const AcScanArgs& a,
                                                     const Table& table,
                                                     int32_t P) {
  const int64_t n = (int64_t)a.B * P;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g0 = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       g0 < n; g0 += stride)
    ac_stepped_lanes<1, Layout>(a, table, a.B, P, g0, threadIdx.x & 31);
}

template <typename Layout, bool OnSm>
__global__ void __launch_bounds__(OnSm ? kDenseSmThreads : kDenseThreads)
    ac_dense_count_kernel(AcScanArgs a, int32_t P, int32_t lut_n, int32_t) {
  extern __shared__ int32_t ac_dense_smem[];
  ac_lut_to_smem(a, lut_n, ac_dense_smem);
  if constexpr (OnSm)
    ac_dense_count_lanes<Layout>(
        a, ac_dense_sm_table(a, ac_dense_smem + lut_n), P);
  else
    ac_dense_count_lanes<Layout>(a, AcDenseTable<int32_t>::make(a), P);
}

// ---------------------------------------------------------------------------
// The batch forms (K5, K6, K9's batch form, K2's time-major form), over
// tables in device memory read through Table: a block of 32 * groups
// columns, a warp's lanes over 32 consecutive columns, so that each row's
// symbol loads (and K2's state stores, one 128-byte row a warp)
// coalesce, and column group w / P's sub-stream w % P in warp w. A
// column's counts meet in uint32 in shared memory after the LUT and its
// first warp writes the total; K2's states go out as they come
// (ac_col_states_part). MaxThreads bounds the block: 256 up to P =
// AC_COLS_SPLIT, so that the compiler is not held to 64 registers (at
// 1,024 threads it spills at k >= 2), 1,024 above.
template <typename Layout, typename Table, int K, bool States,
          int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
    ac_cols_kernel(AcScanArgs a, int32_t P, int32_t lut_n) {
  extern __shared__ int32_t ac_cols_smem[];
  ac_lut_to_smem(a, lut_n, ac_cols_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = warp % P, grp = warp / P;
  const int groups = blockDim.x / (32 * P);
  const int64_t col = ((int64_t)blockIdx.x * groups + grp) * 32 + lane;
  if constexpr (States) {
    if (col < a.B)
      ac_col_states_part<Layout>(a, Table::make(a), Layout::make(a, col),
                                 col, p, P);
  } else {
    uint32_t* part = (uint32_t*)(ac_cols_smem + lut_n);
    part[threadIdx.x] =
        col < a.B ? ac_stepped_part<K>(a, Layout::make(a, col),
                                       Table::make(a), p, P)
                  : 0u;
    __syncthreads();
    if (p == 0 && col < a.B) {
      uint32_t tot = 0;
      for (int q = 0; q < P; ++q) tot += part[(grp * P + q) * 32 + lane];
      a.out[col] = (int32_t)tot;
    }
  }
}

// P warps a column group, at least 4 warps; P from ac_launch_split over
// each P's slots, above AC_COLS_SPLIT only where the launch fits one wave.
int ac_cols_threads(int P) { return 32 * P < 128 ? 128 : 32 * P; }

template <typename Layout, typename Table, int K, bool States>
cudaError_t ac_launch_cols(const AcScanArgs& a, cudaStream_t st) {
  const auto small =
      ac_cols_kernel<Layout, Table, K, States, 32 * AC_COLS_SPLIT>;
  const auto large = ac_cols_kernel<Layout, Table, K, States,
                                    32 * AC_MAX_SPLIT>;
  const int32_t lut_n = ac_lut_entries(a);
  int64_t slots[AC_SPLITS];
  for (int i = 0; i < AC_SPLITS; ++i) {
    const int threads = ac_cols_threads(1 << i);
    AC_TRY(ac_slots((1 << i) <= AC_COLS_SPLIT ? small : large, threads,
                    4 * (lut_n + threads), &slots[i]));
  }
  const int P = ac_launch_split(a, a.B, slots, AC_COLS_SPLIT);
  if (P == 0) return cudaErrorInvalidValue;
  const int threads = ac_cols_threads(P);
  const int64_t cols = 32 * (threads / (32 * P));
  const int64_t grid = (a.B + cols - 1) / cols;
  if (grid == 0) return cudaSuccess;
  (P <= AC_COLS_SPLIT ? small : large)<<<(unsigned)grid, threads,
                                          4 * (lut_n + threads), st>>>(
      a, P, lut_n);
  return cudaGetLastError();
}

}  // namespace
#endif  // __CUDACC__
