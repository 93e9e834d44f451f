// Host build of the per-thread scans in ac_scan.cuh, with the same C entry
// points as the CUDA kernels: each loops over the streams (or batch
// columns, or windows) one by one, the split kernels over their
// sub-streams at the P the card's launcher would pick at full occupancy,
// and the MXU kernels and K1's, K3's, K4's and K7 dense's lanes over their
// warps, each warp's 32 lanes in turn with the tensor-core instruction and
// the warp's votes and shuffles emulated. K1, K2's stream forms, K7 dense
// and K8 read the 1-char tables as the card does: a uint16 copy staged by
// ac_dense_stage where ac_dense_smem_bytes gives it room (the card's shared
// memory), else in place (K6 and K2's time-major form always); K2 stages
// its states, and its one-chain form its chunks of ids and states, as the
// card does, and so do K4 (its words) and K12 (its states).
// Built with g++ by the CPU tests, so that the logic the H100 kernels run
// is tested where there is no GPU; the scanner never loads it.
#include <algorithm>
#include <type_traits>
#include <vector>

#include "ac_scan.cuh"

namespace {

template <void (*U8)(const AcScanArgs&, int64_t),
          void (*I32)(const AcScanArgs&, int64_t)>
int run(const AcScanArgs* a) {
  for (int64_t b = 0; b < a->B; ++b) (a->ext_u8 ? U8 : I32)(*a, b);
  return 0;
}

// P of a stepped launch (ac_launch_split) for an H100 at full occupancy,
// 132 SMs of 2,048 threads, as the card's launcher would pick there; 0 for
// a split that is no power of two in [1, AC_MAX_SPLIT].
int split_of(const AcScanArgs& a, int64_t n_cols, int wide_split) {
  int64_t slots[AC_SPLITS];
  for (int i = 0; i < AC_SPLITS; ++i) slots[i] = 132 * 2048;
  return ac_launch_split(a, n_cols, slots, wide_split);
}

// K1, K3, K9's stream form, K11's gather half: the warps of the card's
// launch over columns [0, n_cols), P lanes a column, each warp's lanes in
// turn.
template <int K, typename Layout, typename Table>
int lanes(const AcScanArgs& a, const Table& table, int64_t n_cols) {
  const int P = split_of(a, n_cols, AC_MAX_SPLIT);
  if (P == 0) return 1;
  for (int64_t g0 = 0; g0 < n_cols * P; g0 += 32)
    ac_stepped_lanes<K, Layout>(a, table, n_cols, P, g0, 0);
  return 0;
}

// K8: the launch's B*P sub-streams one after another, each staging its
// hits in one stage of 2 * kHitStage words where the tables are on "the
// SM" (the card stages them in shared memory there).
template <typename Layout, typename Table>
int hits(const AcScanArgs& a, const Table& table) {
  const int P = split_of(a, a.B, AC_MAX_SPLIT);
  if (P == 0) return 1;
  int32_t stage[2 * kHitStage];
  const bool on_sm = std::is_same<Table, AcDenseTable<uint16_t> >::value;
  for (int64_t g = 0; g < (int64_t)a.B * P; ++g) {
    if (a.hit_pos != nullptr)
      ac_dense_hits_sub<true, Layout>(a, table, g, P,
                                      on_sm ? stage : nullptr, 1);
    else
      ac_dense_hits_sub<false, Layout>(a, table, g, P, nullptr, 1);
  }
  return 0;
}

// fn(table) over the 1-char tables of a K1, K2 or K8 launch (whose block
// holds beside_words more words beside the LUT), as the card reads them;
// with Counts, the tables give each state's matches.
template <bool Counts, typename Fn>
int with_dense_table(const AcScanArgs& a, int64_t beside_words, Fn fn) {
  const int64_t bytes = ac_dense_smem_bytes(
      a, 4 * ((int64_t)ac_lut_entries(a) + beside_words));
  g_ac_last_dense_table = bytes;
  if (bytes == 0) return fn(AcDenseTable<int32_t, Counts>::make(a));
  std::vector<int32_t> smem(bytes / 4);
  return fn(ac_dense_stage<Counts>(a, smem.data(), 0, 1));
}

int stream_hits(const AcScanArgs& a) {
  return with_dense_table<true>(
      a, 2 * kHitStage * kDenseSmThreads, [&](const auto& table) {
    return a.ext_u8 ? hits<AcStreamLayout<uint8_t>>(a, table)
                    : hits<AcStreamLayout<int32_t>>(a, table);
  });
}

// K4: the warps of the card's launch, each warp's 32 lanes in turn, each
// lane staging its words in its own slot of a 32-lane stage.
template <int K, typename Layout>
int emit_lanes(const AcScanArgs& a) {
  const int P = split_of(a, a.B, AC_MAX_SPLIT);
  if (P == 0) return 1;
  int32_t stage[32 * kStateStage];
  for (int64_t g0 = 0; g0 < (int64_t)a.B * P; g0 += 32)
    ac_stepped_emit_lanes<K, Layout>(a, ac_packed(a), P, g0, 0, stage, 32);
  return 0;
}

// K5, K6, K9's batch form: each column's P sub-streams summed.
template <int K, typename Layout, typename Table>
int cols(const AcScanArgs& a, const Table& table) {
  const int P = split_of(a, a.B, AC_COLS_SPLIT);
  if (P == 0) return 1;
  for (int64_t c = 0; c < a.B; ++c)
    a.out[c] = (int32_t)ac_stepped_column<K, Layout>(a, table, c, P);
  return 0;
}

// K2's stream form at P: the launch's B*P sub-streams one after another,
// each staging its states in one stage of kStateStage words.
template <typename Layout, typename Table>
int states(const AcScanArgs& a, const Table& table, int P) {
  int32_t stage[kStateStage];
  for (int64_t g = 0; g < (int64_t)a.B * P; ++g)
    ac_dense_states_sub<Layout>(a, table, g, P, stage, 1);
  return 0;
}

// K2's one-chain form: the window's rows in chunks of kSeqChunk, each
// translated, walked and stored in turn.
template <typename T, typename Table>
int one_chain(const AcScanArgs& a, const Table& table) {
  std::vector<int32_t> ids(kSeqChunk), st(kSeqChunk);
  const AcSyms<T> sym = ac_syms<T>(a, 0);
  const int64_t rows = (int64_t)a.halo + a.L;
  int32_t s = 0;
  for (int64_t t0 = 0; t0 < rows; t0 += kSeqChunk) {
    const int n = (int)std::min<int64_t>(kSeqChunk, rows - t0);
    ac_seq_load(sym, t0, n, ids.data(), 0, 1);
    s = ac_seq_walk(table, a.V, ids.data(), st.data(), n, s);
    ac_seq_store(a, t0, n, st.data(), 0, 1);
  }
  return 0;
}

// K2's time-major form: each column's P sub-streams one after another,
// the tables in place (the card's read-only path).
int states_tm(const AcScanArgs& a) {
  typedef AcBatchLayout<int32_t> Layout;
  const int P = split_of(a, a.B, AC_COLS_SPLIT);
  if (P == 0) return 1;
  const AcDenseTable<int32_t, false> table =
      AcDenseTable<int32_t, false>::make(a);
  for (int64_t c = 0; c < a.B; ++c)
    for (int p = 0; p < P; ++p)
      ac_col_states_part<Layout>(a, table, Layout::make(a, c), c, p, P);
  return 0;
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

int ac_dense_count(const AcScanArgs* args, void*) {
  const AcScanArgs a = ac_dense_args(*args);
  return with_dense_table<true>(a, 0, [&](const auto& table) {
    return a.ext_u8 ? lanes<1, AcStreamLayout<uint8_t>>(a, table, a.B)
                    : lanes<1, AcStreamLayout<int32_t>>(a, table, a.B);
  });
}

int ac_dense_states(const AcScanArgs* args, void*) {
  const AcScanArgs a = ac_dense_args(*args);
  const int P = split_of(a, a.B, AC_MAX_SPLIT);
  if (P == 0) return 1;
  if (a.B == 1 && P == 1)
    return with_dense_table<false>(
        a, 4 * kSeqChunk, [&](const auto& table) {
          return a.ext_u8 ? one_chain<uint8_t>(a, table)
                          : one_chain<int32_t>(a, table);
        });
  return with_dense_table<false>(
      a, kStateStage * kDenseSmThreads, [&](const auto& table) {
        return a.ext_u8 ? states<AcStreamLayout<uint8_t>>(a, table, P)
                        : states<AcStreamLayout<int32_t>>(a, table, P);
      });
}

int ac_stepped_count(const AcScanArgs* a, void*) {
  if (a->ext_u8)
    AC_WITH_K(a->k, return lanes<K, AcStreamLayout<uint8_t>>(
                        *a, AcPackedTable::make(*a), a->B));
  AC_WITH_K(a->k, return lanes<K, AcStreamLayout<int32_t>>(
                      *a, AcPackedTable::make(*a), a->B));
  return 0;
}

int ac_stepped_emit(const AcScanArgs* a, void*) {
  if (a->ext_u8)
    AC_WITH_K(a->k, return emit_lanes<K, AcStreamLayout<uint8_t>>(*a));
  AC_WITH_K(a->k, return emit_lanes<K, AcStreamLayout<int32_t>>(*a));
  return 0;
}

int ac_dense_states_tm(const AcScanArgs* args, void*) {
  return states_tm(ac_dense_args(*args));
}

// K7 dense: the index list's windows as contiguous rows, the elided ones
// strided, on K1's lanes over the tables as the card reads them.
int ac_sparse_count(const AcScanArgs* args, void*) {
  const AcScanArgs a = ac_dense_args(*args);
  return with_dense_table<true>(a, 0, [&](const auto& table) {
    return a.gather ? lanes<1, AcWinRowsLayout>(a, table, a.B)
                    : lanes<1, AcWinLayout>(a, table, a.B);
  });
}

int ac_sparse_count_split(const AcScanArgs* a, int* P) {
  *P = split_of(ac_dense_args(*a), a->B, AC_MAX_SPLIT);
  return *P == 0;
}

int ac_sparse_count_stepped(const AcScanArgs* a, void*) {
  return run<ac_sparse_count_stepped_column,
             ac_sparse_count_stepped_column>(a);
}

int ac_dense_hits(const AcScanArgs* a, void*) {
  return stream_hits(ac_dense_args(*a));
}

int ac_window_hits(const AcScanArgs* args, void*) {
  const AcScanArgs a = ac_dense_args(*args);
  return with_dense_table<true>(
      a, 2 * kHitStage * kDenseSmThreads, [&](const auto& table) {
    return hits<AcWinLayout>(a, table);
  });
}

// K8's P, as the card's launcher picks it at full occupancy.
int ac_dense_hits_split(const AcScanArgs* a, int* P) {
  *P = split_of(ac_dense_args(*a), a->B, AC_MAX_SPLIT);
  return *P == 0;
}

int ac_window_hits_split(const AcScanArgs* a, int* P) {
  return ac_dense_hits_split(a, P);
}

int ac_dense_count_many(const AcScanArgs* args, void*) {
  const AcScanArgs a = ac_dense_args(*args);
  const AcDenseTable<int32_t> table = AcDenseTable<int32_t>::make(a);
  return a.ext_u8 ? cols<1, AcBatchLayout<uint8_t>>(a, table)
                  : cols<1, AcBatchLayout<int32_t>>(a, table);
}

int ac_stepped_count_many(const AcScanArgs* a, void*) {
  if (a->ext_u8)
    AC_WITH_K(a->k,
              return cols<K, AcBatchLayout<uint8_t>>(
                  *a, AcPackedTable::make(*a)));
  AC_WITH_K(a->k, return cols<K, AcBatchLayout<int32_t>>(
                      *a, AcPackedTable::make(*a)));
  return 0;
}

int ac_stepped_count_2t(const AcScanArgs* a, void*) {
  if (a->layout == 1)
    AC_WITH_K(a->k, return cols<K, AcBatchLayout<int32_t>>(
                        *a, AcTwoTables::make(*a)));
  if (a->ext_u8)
    AC_WITH_K(a->k, return lanes<K, AcStreamLayout<uint8_t>>(
                        *a, AcTwoTables::make(*a), a->B));
  AC_WITH_K(a->k, return lanes<K, AcStreamLayout<int32_t>>(
                      *a, AcTwoTables::make(*a), a->B));
  return 0;
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
  int err = 0;
  if (a->ext_u8)
    AC_WITH_K(a->k, err = lanes<K, AcStreamLayout<uint8_t>>(
                        *a, AcPackedTable::make(*a), a->B1));
  else
    AC_WITH_K(a->k, err = lanes<K, AcStreamLayout<int32_t>>(
                        *a, AcPackedTable::make(*a), a->B1));
  if (err) return err;
  if (a->ext_u8)
    return mxu_warps<R, AcStreamLayout<uint8_t>>(*a, a->B1, a->B);
  return mxu_warps<R, AcStreamLayout<int32_t>>(*a, a->B1, a->B);
}

// K12's three phases in turn, delta's rows on "the SM" where they fit
// beside a tile's staged states, the functions in place.
int ac_assoc_scan(const AcScanArgs* args, void*) {
  const AcScanArgs& a = *args;
  if (!ac_assoc_valid(a)) return 1;
  const int64_t S = a.n_states, n_tiles = (a.B + a.tile - 1) / a.tile;
  const int32_t* ids = (const int32_t*)a.ext;
  return with_dense_table<false>(
      a, (int64_t)kStateStage * a.tile, [&](const auto& table) {
    for (int64_t c = 0; c < a.B; ++c)
      for (int32_t s = 0; s < S; ++s)
        ac_assoc_compose(a, table, ids + c * a.L, c, s);
    for (int64_t i = 0; i < n_tiles; ++i)
      for (int32_t s = 0; s < S; ++s)
        ac_assoc_tile(a, a.compose + i * a.tile * S, i, s);
    int32_t stage[kStateStage];
    for (int64_t i = 0; i < n_tiles; ++i) {
      const int32_t start = ac_assoc_apply(a.compose + a.B * S, S, i, 0);
      for (int64_t r = 0; r < ac_assoc_tile_len(a, i); ++r)
        ac_assoc_states(a, table, i * a.tile + r,
                        ac_assoc_apply(a.compose + i * a.tile * S, S, r,
                                       start),
                        stage, 1);
    }
    return 0;
  });
}

const char* ac_error_string(int) { return "host build"; }

int ac_last_split(void) { return g_ac_last_split; }

int64_t ac_last_dense_table(void) { return g_ac_last_dense_table; }

int ac_stepped_split(int64_t n_cols, int64_t n_body, int64_t halo_steps,
                     int64_t warm_steps, const int64_t* slots,
                     int wide_split) {
  return ac_pick_split(n_cols, n_body, halo_steps, warm_steps, slots,
                       wide_split);
}

}  // extern "C"
