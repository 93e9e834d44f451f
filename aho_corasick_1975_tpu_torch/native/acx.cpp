// acx: native host-side Aho-Corasick automaton core.
//
// From-scratch C++ implementation of the goto/fail/output construction the
// reference C library implements over generic pointers + ordered maps
// (aho_corasick.c). Differences are deliberate and
// TPU-first (see SURVEY.md §7):
//   * the alphabet is dense int32 letter ids (the Python vocab layer resolves
//     generic signs / comparators once at registration, not per operation);
//   * states are structure-of-arrays indexed by creation-order id (ids match
//     the reference's debug UIDs, c:61);
//   * both construction modes are runtime-selectable, not compile-time:
//     Meyer-1985 incremental fail maintenance (ref c:194-265) and AC75 lazy
//     BFS reconstruction (ref c:365-418);
//   * emission of the dense fail-collapsed transition table for device scans
//     happens here (BFS row-copy), replacing the reference's runtime
//     state_goto fail-chain walk (c:167-192).
//
// Exposed as a flat C ABI consumed via ctypes (core/native.py); no Python.h
// dependency.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int32_t kRoot = 0;
constexpr int32_t kNoState = -1;

// ---- lock-free reader primitives ----------------------------------------
// The match path (acx_match / acx_match_bulk / acx_get_match_state) runs
// WITHOUT the machine lock, restoring the reference's non-blocking
// concurrent insert+scan property (reference README.md:364). Readers never
// touch the writer's canonical structures; they read a published shadow
// (pub_* arrays + the shared edge table, bounds-checked against pub_n)
// that writers advance only at the end of each locked mutation. Retired
// allocations (edge-table rehashes, shadow-array growth) are kept on a
// graveyard and freed only when no reader is in flight.

template <typename T>
static inline T ld_acq(const T* p) {
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
}
template <typename T>
static inline T ld_sc(const T* p) {
  return __atomic_load_n(p, __ATOMIC_SEQ_CST);
}
template <typename T>
static inline void st_rel(T* p, T v) {
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
}
template <typename T>
static inline void st_sc(T* p, T v) {
  __atomic_store_n(p, v, __ATOMIC_SEQ_CST);
}
// Relaxed pair for counters written under the lock but read by the
// unlocked introspection accessors (acx_n_states & co): mixed plain-write
// / atomic-read access is formally a data race — the writer
// side must be atomic too. Relaxed suffices: introspection tolerates
// momentarily-stale values, and mutual exclusion among writers comes from
// the machine lock.
template <typename T>
static inline T ld_rlx(const T* p) {
  return __atomic_load_n(p, __ATOMIC_RELAXED);
}
template <typename T>
static inline void st_rlx(T* p, T v) {
  __atomic_store_n(p, v, __ATOMIC_RELAXED);
}

struct Graveyard {
  std::vector<void*> pending;
  void retire(void* p) {
    if (p) pending.push_back(p);
  }
  void drain() {
    for (void* p : pending) free(p);
    pending.clear();
  }
  ~Graveyard() { drain(); }
};

// Published shadow array: the buffer pointer is seq_cst-published so a
// reader holding an old pointer keeps a valid (graveyard-retained)
// allocation; element visibility is governed by pub_n (see
// Machine::publish_locked).
template <typename T>
struct PubArr {
  T* buf = nullptr;
  size_t cap = 0;

  // Grow, preserving the first n_keep published elements.
  void grow_keep(size_t need, size_t n_keep, Graveyard* gy) {
    if (need <= cap) return;
    size_t nc = cap ? cap : 1024;
    while (nc < need) nc <<= 1;
    T* nb = static_cast<T*>(malloc(nc * sizeof(T)));
    if (buf) {
      std::memcpy(nb, buf, n_keep * sizeof(T));
      gy->retire(buf);
    }
    st_sc(&buf, nb);
    cap = nc;
  }

  // Full republish: allocate fresh (caller fills all entries, then
  // commit() swaps it in).
  T* fresh(size_t need) {
    size_t nc = cap ? cap : 1024;
    while (nc < need) nc <<= 1;
    return static_cast<T*>(malloc(nc * sizeof(T)));
  }
  void commit(T* nb, size_t need, Graveyard* gy) {
    size_t nc = cap ? cap : 1024;
    while (nc < need) nc <<= 1;
    gy->retire(buf);
    st_sc(&buf, nb);
    cap = nc;
  }
};
// All trie edges live in ONE open-addressing hash table keyed by
// (state, letter) — no per-state containers, no per-edge allocations.
// Profiling showed per-state sorted vectors cost ~1us/char in allocator
// and memmove traffic; the flat hash inserts and finds in O(1) with one
// or two cache misses, which is what a 2.5M-state dictionary build needs.
constexpr uint32_t kLetterBits = 21;  // vocab ids are dense; 2M letters max
constexpr uint64_t kEmptyKey = ~0ULL;

inline uint64_t edge_key(int32_t state, int32_t letter) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(state)) << kLetterBits) |
         static_cast<uint32_t>(letter);
}

inline uint64_t mix64(uint64_t x) {  // splitmix64 finalizer
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// 16-byte key+value slots: one cache line touch per probe (split key/val
// arrays cost a second miss per lookup — measurable on multi-million-
// state builds).
struct Slot {
  uint64_t key;
  int32_t val;
  int32_t pad;
};

struct EdgeTable {
  size_t mask;
  Slot slots[];  // flexible array member (GNU extension, g++/clang)
};

struct EdgeMap {
  EdgeTable* cur = nullptr;  // writer view; == pub except mid-rehash
  EdgeTable* pub = nullptr;  // lock-free readers seq_cst-load this
  size_t count = 0;
  Graveyard* gy = nullptr;

  void init(Graveyard* g) {
    gy = g;
    rehash(1 << 16);
  }

  static EdgeTable* alloc(size_t cap) {
    EdgeTable* t = static_cast<EdgeTable*>(
        malloc(sizeof(EdgeTable) + cap * sizeof(Slot)));
    t->mask = cap - 1;
    for (size_t i = 0; i < cap; ++i) t->slots[i] = Slot{kEmptyKey, 0, 0};
    return t;
  }

  void rehash(size_t cap) {
    EdgeTable* nt = alloc(cap);
    if (cur) {
      for (size_t i = 0; i <= cur->mask; ++i) {
        const Slot& s = cur->slots[i];
        if (s.key == kEmptyKey) continue;
        size_t j = mix64(s.key) & nt->mask;
        while (nt->slots[j].key != kEmptyKey) j = (j + 1) & nt->mask;
        nt->slots[j] = s;
      }
      gy->retire(cur);
    }
    cur = nt;
    st_sc(&pub, nt);  // readers switch; the old table stays on the graveyard
  }

  int32_t find(int32_t state, int32_t letter) const {
    uint64_t k = edge_key(state, letter);
    size_t j = mix64(k) & cur->mask;
    for (;;) {
      const Slot& s = cur->slots[j];
      if (s.key == k) return s.val;
      if (s.key == kEmptyKey) return -1;
      j = (j + 1) & cur->mask;
    }
  }

  void insert(int32_t state, int32_t letter, int32_t child) {
    if ((count + 1) * 2 >= (cur->mask + 1)) rehash((cur->mask + 1) * 2);
    uint64_t k = edge_key(state, letter);
    size_t j = mix64(k) & cur->mask;
    while (cur->slots[j].key != kEmptyKey) j = (j + 1) & cur->mask;
    // Value first, then the key with release: a concurrent reader that
    // observes the key also observes the value (and, because enter_child
    // publishes the edge last, the child's canonical fields — though
    // readers only consult the pub_* shadow, bounds-checked by pub_n).
    cur->slots[j].val = child;
    st_rel(&cur->slots[j].key, k);
    ++count;
  }

  void reserve_edges(size_t n) {
    size_t need = 1;
    while (need < (n + count) * 2) need <<= 1;
    if (need > cur->mask + 1) rehash(need);
  }

  void prefetch(int32_t state, int32_t letter) const {
    __builtin_prefetch(&cur->slots[mix64(edge_key(state, letter)) &
                                   cur->mask]);
  }
};

// Reader-side probe over a published table snapshot. Open addressing never
// moves a slot in place, so a concurrent writer append is observed either
// fully (release-stored key, value written before) or not at all; probe
// chains stay terminated because the writer rehashes (into a NEW table)
// before the load factor can exhaust empty slots.
static inline int32_t table_find(const EdgeTable* t, int32_t state,
                                 int32_t letter) {
  uint64_t k = edge_key(state, letter);
  size_t j = mix64(k) & t->mask;
  for (;;) {
    uint64_t key = ld_acq(&t->slots[j].key);
    if (key == k) return t->slots[j].val;
    if (key == kEmptyKey) return kNoState;
    j = (j + 1) & t->mask;
  }
}

struct Machine {
  bool incremental;  // true = Meyer 1985, false = AC75 lazy BFS
  EdgeMap edges;
  size_t n_states_ = 0;
  std::vector<int32_t> fail;
  std::vector<int32_t> prev_state;
  std::vector<int32_t> prev_letter;
  std::vector<uint8_t> is_end;
  std::vector<int64_t> nb_outputs;
  std::vector<int32_t> depth;
  std::vector<int64_t> kw_rank;
  // Meyer IF = f^-1 record (ref c:62-64) as intrusive doubly-linked lists:
  // every state is a member of exactly one IF set (its fail state's), so
  // three flat arrays give O(1) add/remove with zero allocation —
  // if_head[s] starts IF[s]; if_next/if_prev link members.
  std::vector<int32_t> if_head;
  std::vector<int32_t> if_next;
  std::vector<int32_t> if_prev;
  int64_t nb_sequences = 0;
  int64_t reconstruct = 0;  // AC75 dirty counter (ref c:70); atomic access
  int64_t version = 0;
  int32_t max_letter = 0;
  int64_t max_end_depth = 0;  // longest keyword; halo bound for threaded scan
  std::mutex token;  // ref machine->token (c:81)
  // Concurrency model: the reference leaves its match path lock-free
  // (README.md:364). Its trie nodes are individually allocated and
  // pointer-stable, so unsynchronized readers there can chase pointers
  // safely; here the edge hash rehashes and the SoA arrays grow (memory
  // moves). Matchers therefore read a PUBLISHED SHADOW instead of the
  // writer's canonical structures:
  //   * fail_pub / nb_pub / ie_pub mirror fail / nb_outputs / is_end in
  //     graveyard-retained buffers;
  //   * pub_n bounds what a reader may dereference — states and edge
  //     targets >= pub_n are treated as absent (an in-flight insertion is
  //     simply not visible yet, the reference's own semantics for
  //     registration during scan, README.md:352-356);
  //   * writers mutate canonical state under the lock and call
  //     publish_locked() once per API mutation; ordering inside
  //     publish_locked makes visibility monotone — a keyword fully
  //     inserted before a match call begins is always counted, and
  //     readers can never crash or fail to terminate.
  // Retired allocations are freed when no reader is in flight (`readers`).
  Graveyard gy;             // owns retired buffers until quiescence
  PubArr<int32_t> fail_pub;
  PubArr<int64_t> nb_pub;
  PubArr<uint8_t> ie_pub;
  int64_t pub_n = 0;        // release-stored; readers acquire
  int64_t readers = 0;      // active lock-free matcher calls (seq_cst)
  std::vector<int32_t> touched;  // states mutated in place since publish

  explicit Machine(bool inc) : incremental(inc) {
    edges.init(&gy);
    new_state();
    publish_locked(false);  // ctor is single-threaded; root becomes visible
  }

  ~Machine() {
    free(edges.cur);  // == edges.pub at quiescence
    free(fail_pub.buf);
    free(nb_pub.buf);
    free(ie_pub.buf);
  }

  // Publish the reader shadow; caller holds the lock (or is the ctor).
  // Ordering contract (all against readers that run without the lock):
  //   1. appended states' fields are plain-stored BEFORE pub_n is
  //      release-stored — a reader that passes the pub_n bounds check
  //      sees initialized fields;
  //   2. in-place changes to already-published states (Meyer fail
  //      rewires, output-count bumps, end flags) are release-stored
  //      AFTER pub_n — a reader that observes a rewire pointing at a new
  //      state will, after refreshing its view, find pub_n already
  //      covering that state (never a dangling target);
  //   3. within (2), is_end before nb_outputs — a reader that sees a
  //      state's count include a new keyword also finds the end flag the
  //      fail-chain walk needs (acx_get_match_state).
  // full=true re-publishes everything into FRESH buffers (bulk insert,
  // restore, AC75 BFS reconstruction — paths that rewrite already-
  // published entries wholesale); readers then see either the complete
  // old automaton or the complete new one, never a mixture.
  void publish_locked(bool full) {
    size_t S = n_states_;
    size_t old_n = static_cast<size_t>(pub_n);
    if (full) {
      int32_t* f = fail_pub.fresh(S);
      int64_t* nb = nb_pub.fresh(S);
      uint8_t* ie = ie_pub.fresh(S);
      for (size_t s = 0; s < S; ++s) {
        f[s] = (fail[s] == kNoState) ? kRoot : fail[s];
        nb[s] = nb_outputs[s];
        ie[s] = is_end[s];
      }
      fail_pub.commit(f, S, &gy);
      nb_pub.commit(nb, S, &gy);
      ie_pub.commit(ie, S, &gy);
      st_rel(&pub_n, static_cast<int64_t>(S));
    } else {
      fail_pub.grow_keep(S, old_n, &gy);
      nb_pub.grow_keep(S, old_n, &gy);
      ie_pub.grow_keep(S, old_n, &gy);
      for (size_t s = old_n; s < S; ++s) {
        fail_pub.buf[s] = (fail[s] == kNoState) ? kRoot : fail[s];
        nb_pub.buf[s] = nb_outputs[s];
        ie_pub.buf[s] = is_end[s];
      }
      st_rel(&pub_n, static_cast<int64_t>(S));
      for (int32_t s : touched) st_rel(&ie_pub.buf[s], is_end[s]);
      for (int32_t s : touched)
        st_rel(&fail_pub.buf[s],
               (fail[s] == kNoState) ? kRoot : fail[s]);
      for (int32_t s : touched) st_rel(&nb_pub.buf[s], nb_outputs[s]);
    }
    touched.clear();
    if (ld_sc(&readers) == 0) gy.drain();
  }

  int32_t new_state() {
    int32_t s = static_cast<int32_t>(n_states_);
    st_rlx(&n_states_, n_states_ + 1);
    fail.push_back(s == kRoot ? kNoState : kRoot);
    prev_state.push_back(kNoState);
    prev_letter.push_back(0);
    is_end.push_back(0);
    nb_outputs.push_back(0);
    depth.push_back(0);
    kw_rank.push_back(-1);
    if_head.push_back(kNoState);
    if_next.push_back(kNoState);
    if_prev.push_back(kNoState);
    return s;
  }

  void if_add(int32_t target, int32_t member) {
    int32_t h = if_head[target];
    if_next[member] = h;
    if_prev[member] = kNoState;
    if (h != kNoState) if_prev[h] = member;
    if_head[target] = member;
  }

  void if_remove(int32_t target, int32_t member) {
    int32_t p = if_prev[member], nx = if_next[member];
    if (p != kNoState) if_next[p] = nx; else if_head[target] = nx;
    if (nx != kNoState) if_prev[nx] = p;
    if_next[member] = if_prev[member] = kNoState;
  }

  // ref state_goto (c:167-192): root LOOP_0 simulated.
  int32_t goto_existing(int32_t state, int32_t letter) const {
    for (;;) {
      int32_t nxt = edges.find(state, letter);
      if (nxt != kNoState) return nxt;
      if (state == kRoot) return kRoot;
      state = fail[state];
    }
  }

  // ref complete_fail_state (c:194-208)
  void complete_fail_state(int32_t r, int32_t s, int32_t a) {
    fail[s] = (r == kRoot) ? kRoot : goto_existing(fail[r], a);
    nb_outputs[s] += nb_outputs[fail[s]];
  }

  // ref complete_inverse_one_ifs + update_fail_state (c:211-239), iterative.
  void complete_inverse(int32_t n, int32_t nprime, int32_t c,
                        std::vector<int32_t>& stack) {
    // Snapshot members onto the stack before visiting: a visited x' gets
    // unlinked from the very list being expanded when its old fail equals
    // a node under traversal, which live iteration would not survive.
    stack.clear();
    for (int32_t x = if_head[n]; x != kNoState; x = if_next[x])
      stack.push_back(x);
    while (!stack.empty()) {
      int32_t x = stack.back();
      stack.pop_back();
      int32_t xprime = edges.find(x, c);
      if (xprime != kNoState) {
        if_remove(fail[xprime], xprime);
        fail[xprime] = nprime;
        touched.push_back(xprime);  // published after pub_n covers nprime
        if_add(nprime, xprime);
      } else {
        for (int32_t y = if_head[x]; y != kNoState; y = if_next[y])
          stack.push_back(y);
      }
    }
  }

  int32_t enter_child(int32_t n, int32_t c, std::vector<int32_t>& scratch) {
    int32_t nprime = new_state();
    edges.insert(n, c, nprime);
    prev_state[nprime] = n;
    prev_letter[nprime] = c;
    depth[nprime] = depth[n] + 1;
    if (c > ld_rlx(&max_letter)) st_rlx(&max_letter, c);
    if (incremental) {
      complete_fail_state(n, nprime, c);
      if_add(fail[nprime], nprime);
      complete_inverse(n, nprime, c, scratch);
    }
    return nprime;
  }

  int32_t insert_letter(int32_t state, int32_t letter) {
    std::lock_guard<std::mutex> lock(token);
    int32_t nxt = edges.find(state, letter);
    if (nxt != kNoState) return nxt;
    std::vector<int32_t> scratch;
    nxt = enter_child(state, letter, scratch);
    publish_locked(false);
    return nxt;
  }

  // ref enter_output (c:330-338): Meyer propagates over the IF closure.
  void enter_output(int32_t n, std::vector<int32_t>& stack) {
    if (!incremental) {
      nb_outputs[n] += 1;
      touched.push_back(n);
      return;
    }
    stack.assign(1, n);
    while (!stack.empty()) {
      int32_t s = stack.back();
      stack.pop_back();
      nb_outputs[s] += 1;
      touched.push_back(s);
      for (int32_t y = if_head[s]; y != kNoState; y = if_next[y])
        stack.push_back(y);
    }
  }

  // returns 1 if the keyword is new (ref acm_insert_end_of_keyword c:340-363)
  int32_t insert_end(int32_t state) {
    std::lock_guard<std::mutex> lock(token);
    st_rlx(&version, version + 1);
    if (is_end[state]) return 0;
    std::vector<int32_t> stack;
    enter_output(state, stack);
    is_end[state] = 1;
    touched.push_back(state);
    kw_rank[state] = nb_sequences;
    st_rlx(&nb_sequences, nb_sequences + 1);
    if (depth[state] > max_end_depth)
      st_rel(&max_end_depth, static_cast<int64_t>(depth[state]));
    __atomic_fetch_add(&reconstruct, int64_t{1}, __ATOMIC_RELAXED);
    publish_locked(false);
    return 1;
  }

  // Per-state child ranges reconstructed from prev_state/prev_letter by
  // counting sort (parent-major, letter order within a parent irrelevant
  // to construction; export sorts in Python where comparator order lives).
  // child_list holds state ids; child_start[s]..child_start[s+1] delimit
  // the children of s.
  void build_children(std::vector<int32_t>& child_start,
                      std::vector<int32_t>& child_list) const {
    size_t S = n_states_;
    child_start.assign(S + 1, 0);
    for (size_t s = 1; s < S; ++s) ++child_start[prev_state[s] + 1];
    for (size_t s = 0; s < S; ++s) child_start[s + 1] += child_start[s];
    child_list.assign(S ? S - 1 : 0, 0);
    std::vector<int32_t> cursor(child_start.begin(), child_start.end() - 1);
    for (size_t s = 1; s < S; ++s)
      child_list[cursor[prev_state[s]]++] = static_cast<int32_t>(s);
  }

  // Depth-ascending order (fail[s] is always strictly shallower than s).
  void depth_order(std::vector<int32_t>& order) const {
    size_t S = n_states_;
    int32_t maxd = 0;
    for (size_t s = 0; s < S; ++s) maxd = std::max(maxd, depth[s]);
    std::vector<int32_t> bucket_start(maxd + 2, 0);
    for (size_t s = 0; s < S; ++s) ++bucket_start[depth[s] + 1];
    for (int32_t d = 0; d <= maxd; ++d) bucket_start[d + 1] += bucket_start[d];
    order.assign(S, 0);
    std::vector<int32_t> cursor(bucket_start.begin(), bucket_start.end() - 1);
    for (size_t s = 0; s < S; ++s)
      order[cursor[depth[s]]++] = static_cast<int32_t>(s);
  }

  // Full fail/output reconstruction + Meyer IF-set rebuild — used by the
  // deferred bulk-insert path. Equivalent to incremental maintenance by
  // the Meyer==AC75 equivalence (tests/test_meyer_equivalence.py); the
  // machine lock is held for the whole bulk call, so no intermediate
  // state is observable through the API. Caller must hold the lock.
  void rebuild_all() {
    std::vector<int32_t> order;
    depth_order(order);
    for (int32_t s : order) {
      if (s == kRoot) continue;
      nb_outputs[s] = is_end[s] ? 1 : 0;
      complete_fail_state(prev_state[s], s, prev_letter[s]);
    }
    if (incremental) {
      size_t S = n_states_;
      std::fill(if_head.begin(), if_head.end(), kNoState);
      std::fill(if_next.begin(), if_next.end(), kNoState);
      std::fill(if_prev.begin(), if_prev.end(), kNoState);
      for (size_t s = 1; s < S; ++s)
        if_add(fail[s], static_cast<int32_t>(s));
    }
    // NOTE: `reconstruct` is NOT cleared here. Callers clear it with a
    // release store AFTER publish_locked — a lock-free matcher whose
    // double-check observes reconstruct==0 must already see the rebuilt
    // shadow (clearing before publish would let it scan the
    // pre-rebuild tables).
  }

  // ref state_fail_state_construct (c:386-417); BFS == depth order here.
  // Caller must hold the lock.
  void ensure_fail_states_locked() {
    if (incremental || !ld_acq(&reconstruct)) return;
    std::vector<int32_t> order;
    depth_order(order);
    for (int32_t s : order) {
      if (s == kRoot) continue;
      nb_outputs[s] = is_end[s] ? 1 : 0;  // re-entrant reset (ref c:381)
      complete_fail_state(prev_state[s], s, prev_letter[s]);
    }
    publish_locked(true);  // the BFS rewrote published entries wholesale
    // Clear the dirty flag only AFTER the shadow publish: a concurrent
    // lock-free matcher double-checks reconstruct without the lock
    // (ensure_fail_states), and observing 0 must imply the post-BFS
    // shadow is visible (release here pairs with its acquire load).
    st_rel(&reconstruct, int64_t{0});
  }

  void ensure_fail_states() {
    // Double-checked (ref c:389-394). `incremental` is read atomically:
    // the deferred-bulk path flips it briefly under the lock, and a
    // matcher observing that window simply serializes behind the batch.
    if (ld_acq(&incremental) || !ld_acq(&reconstruct)) return;
    std::lock_guard<std::mutex> lock(token);
    ensure_fail_states_locked();
  }
};

// ---- lock-free matcher path ---------------------------------------------

// Counts a matcher in flight so writers keep retired buffers alive.
struct ReaderScope {
  Machine* m;
  explicit ReaderScope(Machine* mm) : m(mm) {
    __atomic_fetch_add(&m->readers, int64_t{1}, __ATOMIC_SEQ_CST);
  }
  ~ReaderScope() {
    __atomic_fetch_sub(&m->readers, int64_t{1}, __ATOMIC_SEQ_CST);
  }
};

struct RView {
  const EdgeTable* t;
  const int32_t* fail;
  const int64_t* nb;
  const uint8_t* ie;
  int64_t n;
};

// pub_n FIRST, pointers after: buffers only grow, so a pointer at least
// as new as the bound can always be indexed up to the bound.
static inline void view_load(const Machine* m, RView* v) {
  v->n = ld_acq(&m->pub_n);
  v->t = ld_sc(&m->edges.pub);
  v->fail = ld_sc(&m->fail_pub.buf);
  v->nb = ld_sc(&m->nb_pub.buf);
  v->ie = ld_sc(&m->ie_pub.buf);
}

// Follow the published fail link; targets outside the view trigger one
// refresh (the publish ordering guarantees the refreshed bound covers any
// observed rewire target), then fall back to root — crash-free under any
// interleaving, and each step strictly decreases depth, so walks
// terminate.
static inline int32_t view_fail(const Machine* m, RView* v, int32_t state) {
  int32_t f = ld_acq(&v->fail[state]);
  if (f < 0 || f >= v->n) {
    view_load(m, v);
    f = ld_acq(&v->fail[state]);
    if (f < 0 || f >= v->n) f = kRoot;
  }
  return f;
}

// ref state_goto (c:167-192) over the published shadow, root LOOP_0
// simulated; edge targets not yet covered by pub_n are treated as absent
// (the in-flight insertion is not visible yet, README.md:352-356).
static int32_t view_goto(const Machine* m, RView* v, int32_t state,
                         int32_t letter) {
  for (;;) {
    int32_t nxt = table_find(v->t, state, letter);
    if (nxt != kNoState && nxt >= v->n) {
      view_load(m, v);
      if (nxt >= v->n) nxt = kNoState;
    }
    if (nxt != kNoState) return nxt;
    if (state == kRoot) return kRoot;
    state = view_fail(m, v, state);
  }
}

}  // namespace

extern "C" {

Machine* acx_create(int incremental) { return new Machine(incremental != 0); }

void acx_release(Machine* m) { delete m; }

int32_t acx_insert_letter(Machine* m, int32_t state, int32_t letter) {
  return m->insert_letter(state, letter);
}

int32_t acx_insert_end(Machine* m, int32_t state) {
  return m->insert_end(state);
}

// Bulk keyword insertion: letters = concatenated keyword letter ids,
// offsets[i]..offsets[i+1] delimit keyword i. end_states[i] receives the
// end state; new_flags[i] gets 1 if the keyword was new.
void acx_insert_keywords(Machine* m, const int32_t* letters,
                         const int64_t* offsets, int64_t n_keywords,
                         int32_t* end_states, int8_t* new_flags) {
  std::lock_guard<std::mutex> lock(m->token);
  // Large Meyer batches: skip per-edge incremental fail maintenance and
  // rebuild everything once at the end (identical result, far cheaper).
  bool deferred = m->incremental && offsets[n_keywords] > 4096;
  if (deferred) st_rel(&m->incremental, false);
  m->edges.reserve_edges(static_cast<size_t>(offsets[n_keywords]));
  size_t reserve_states = m->n_states_ + offsets[n_keywords];
  m->fail.reserve(reserve_states);
  m->prev_state.reserve(reserve_states);
  m->prev_letter.reserve(reserve_states);
  m->is_end.reserve(reserve_states);
  m->nb_outputs.reserve(reserve_states);
  m->depth.reserve(reserve_states);
  m->kw_rank.reserve(reserve_states);
  m->if_head.reserve(reserve_states);
  m->if_next.reserve(reserve_states);
  m->if_prev.reserve(reserve_states);
  std::vector<int32_t> scratch, stack;
  // Two-phase waves: phase A walks a wave of keywords READ-ONLY through
  // the existing trie with software-pipelined prefetching (keywords are
  // independent, so their probe chains overlap and hide hash-miss
  // latency); phase B completes each keyword IN ORDER — re-probing past
  // the phase-A endpoint first, since an earlier keyword in the same wave
  // may have created a shared prefix — so state ids and ranks are
  // assigned in exactly the sequential order (the determinism contract
  // behind backend parity and reference-dump parity).
  constexpr int64_t kWave = 128;
  int32_t endpoint[kWave];
  int64_t resume[kWave];
  for (int64_t wave = 0; wave < n_keywords; wave += kWave) {
    int64_t wn = std::min(kWave, n_keywords - wave);
    // phase A: interleaved read-only prefix walks
    int64_t pos[kWave];
    bool done[kWave];
    int64_t remaining = wn;
    for (int64_t w = 0; w < wn; ++w) {
      endpoint[w] = kRoot;
      pos[w] = offsets[wave + w];
      done[w] = pos[w] >= offsets[wave + w + 1];
      if (done[w]) --remaining;
      else m->edges.prefetch(kRoot, letters[pos[w]]);
    }
    while (remaining > 0) {
      for (int64_t w = 0; w < wn; ++w) {
        if (done[w]) continue;
        int32_t nxt = m->edges.find(endpoint[w], letters[pos[w]]);
        if (nxt == kNoState) {
          done[w] = true;
          --remaining;
          continue;
        }
        endpoint[w] = nxt;
        if (++pos[w] >= offsets[wave + w + 1]) {
          done[w] = true;
          --remaining;
        } else {
          m->edges.prefetch(endpoint[w], letters[pos[w]]);
        }
      }
    }
    for (int64_t w = 0; w < wn; ++w)
      resume[w] = pos[w];
    // phase B: in-order completion (finds may extend past the phase-A
    // endpoint through nodes created for earlier keywords in this wave)
    for (int64_t w = 0; w < wn; ++w) {
      int64_t i = wave + w;
      int32_t state = endpoint[w];
      for (int64_t j = resume[w]; j < offsets[i + 1]; ++j) {
        int32_t letter = letters[j];
        int32_t nxt = m->edges.find(state, letter);
        state = (nxt != kNoState) ? nxt
                                  : m->enter_child(state, letter, scratch);
      }
      st_rlx(&m->version, m->version + 1);
      int8_t fresh = 0;
      if (state != kRoot && !m->is_end[state]) {
        m->enter_output(state, stack);
        m->is_end[state] = 1;
        m->touched.push_back(state);
        m->kw_rank[state] = m->nb_sequences;
        st_rlx(&m->nb_sequences, m->nb_sequences + 1);
        if (m->depth[state] > m->max_end_depth)
          st_rel(&m->max_end_depth,
                 static_cast<int64_t>(m->depth[state]));
        __atomic_fetch_add(&m->reconstruct, int64_t{1}, __ATOMIC_RELAXED);
        fresh = 1;
      }
      if (end_states) end_states[i] = state;
      if (new_flags) new_flags[i] = fresh;
    }
  }
  if (deferred) {
    st_rel(&m->incremental, true);
    m->rebuild_all();
  }
  // One publish for the whole batch: lock-free matchers see the pre-batch
  // automaton until here, then the complete post-batch one. The deferred
  // rebuild rewrote published entries, so it must republish in full; its
  // dirty-flag clear comes after the publish (see rebuild_all note).
  m->publish_locked(deferred);
  if (deferred) st_rel(&m->reconstruct, int64_t{0});
}

// Creation-order edge replay (checkpoint restore, utils/checkpoint.py):
// recreates state s as exactly id s from its (parent, letter) backlink —
// the whole trie in ONE FFI call instead of one insert_letter round-trip
// per state. Returns 0 on success, else the id of the first state whose
// recreated id diverged (corrupt checkpoint). Same deferred-rebuild trick
// as acx_insert_keywords: for big Meyer machines the per-edge incremental
// fail maintenance is skipped and fail/IF are rebuilt once at the end
// (identical result by the Meyer==AC75 equivalence); output counts are
// correct because end marking (acx_insert_ends) happens AFTER this call
// and propagates over the rebuilt IF sets.
int64_t acx_restore_machine(Machine* m, const int32_t* prev_state,
                            const int32_t* prev_letter,
                            const uint8_t* is_end, const int32_t* kw_rank,
                            int64_t S) {
  std::lock_guard<std::mutex> lock(m->token);
  bool was_inc = m->incremental;
  st_rel(&m->incremental, false);  // skip per-edge fail/IF maintenance
  m->edges.reserve_edges(static_cast<size_t>(S));
  size_t reserve_states = m->n_states_ + static_cast<size_t>(S);
  m->fail.reserve(reserve_states);
  m->prev_state.reserve(reserve_states);
  m->prev_letter.reserve(reserve_states);
  m->is_end.reserve(reserve_states);
  m->nb_outputs.reserve(reserve_states);
  m->depth.reserve(reserve_states);
  m->kw_rank.reserve(reserve_states);
  m->if_head.reserve(reserve_states);
  m->if_next.reserve(reserve_states);
  m->if_prev.reserve(reserve_states);
  std::vector<int32_t> scratch;
  for (int64_t s = 1; s < S; ++s) {
    int32_t nxt = m->edges.find(prev_state[s], prev_letter[s]);
    if (nxt == kNoState)
      nxt = m->enter_child(prev_state[s], prev_letter[s], scratch);
    if (nxt != s) {
      st_rel(&m->incremental, was_inc);
      if (was_inc) m->rebuild_all();
      m->publish_locked(true);
      if (was_inc) st_rel(&m->reconstruct, int64_t{0});
      return s;
    }
  }
  // Adopt end flags and ranks verbatim (ranks are a 0..n-1 permutation in
  // a valid checkpoint); output counts come from the single rebuild below
  // (nb_outputs[s] = is_end[s] + nb_outputs[fail[s]] in depth order) —
  // not from per-end IF-closure propagation, which dominated the replay
  // at pod-dictionary scale.
  int64_t n_seq = 0;
  for (int64_t s = 0; s < S; ++s) {
    if (!is_end[s]) continue;
    m->is_end[s] = 1;
    m->kw_rank[s] = kw_rank[s];
    if (m->depth[s] > m->max_end_depth)
      st_rel(&m->max_end_depth, static_cast<int64_t>(m->depth[s]));
    ++n_seq;
    __atomic_fetch_add(&m->reconstruct, int64_t{1}, __ATOMIC_RELAXED);
  }
  st_rlx(&m->nb_sequences, n_seq);
  st_rel(&m->incremental, was_inc);
  if (was_inc) m->rebuild_all();  // fail + IF + output counts, one pass
  // AC75 machines leave `reconstruct` dirty: the lazy BFS before the next
  // match recomputes fail/output exactly like a live-built machine. Meyer
  // machines clear it only after the publish (see rebuild_all note).
  m->publish_locked(true);
  if (was_inc) st_rel(&m->reconstruct, int64_t{0});
  return 0;
}

// The three matcher entry points are LOCK-FREE (the reference's
// non-blocking match property, README.md:364): they read the published
// shadow, never the writer's canonical structures. In AC75 mode a dirty
// automaton first runs the lazy BFS under the double-checked lock —
// exactly the reference's acm_match preamble (c:443-446).

int64_t acx_match(Machine* m, int32_t state, int32_t letter,
                  int32_t* next_state) {
  m->ensure_fail_states();
  ReaderScope scope(m);
  RView v;
  view_load(m, &v);
  if (state < 0 || state >= v.n) state = kRoot;  // stale/foreign cursor
  int32_t nxt = view_goto(m, &v, state, letter);
  *next_state = nxt;
  return ld_acq(&v.nb[nxt]);
}

// Streaming bulk match: advances through n letters, returns total match
// count, leaves the final cursor in *state_io.
int64_t acx_match_bulk(Machine* m, int32_t* state_io, const int32_t* letters,
                       int64_t n) {
  m->ensure_fail_states();
  ReaderScope scope(m);
  RView v;
  view_load(m, &v);
  int32_t s = *state_io;
  if (s < 0 || s >= v.n) s = kRoot;
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    s = view_goto(m, &v, s, letters[i]);
    total += ld_acq(&v.nb[s]);
  }
  *state_io = s;
  return total;
}

// Halo-blocked THREADED single-stream count: the host mirror of the
// device kernel's sequence parallelism (ops/blocking.py). The stream
// splits into contiguous chunks; every chunk after the first warms up
// from the root over the `max_end_depth` symbols that precede it — by
// the suffix property of AC states the warm-up reaches exactly the state
// the sequential scan holds there, so per-chunk counts are exact
// (warm-up positions do not count). Lock-free readers make the fan-out
// safe against concurrent insertion; with inserts in flight, chunk
// visibility is per-thread (each worker pins its own published view),
// the same weak-but-monotone contract as acx_match_bulk. Returns the
// total; *state_io advances to the final cursor. n_threads_req <= 0
// picks a hardware-based default.
int64_t acx_match_stream_threaded(Machine* m, int32_t* state_io,
                                  const int32_t* letters, int64_t n,
                                  int64_t n_threads_req) {
  m->ensure_fail_states();
  int64_t halo = ld_acq(&m->max_end_depth);
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = n_threads_req > 0
      ? n_threads_req
      : (hw >= 2 ? std::max<int64_t>(2, hw / 2) : 1);
  // Each chunk must dwarf its warm-up and the thread-spawn cost.
  int64_t min_chunk = 4 * halo + 65536;
  if (n_threads > 1 && n / n_threads < min_chunk)
    n_threads = std::max<int64_t>(1, n / min_chunk);
  if (n_threads <= 1) return acx_match_bulk(m, state_io, letters, n);

  std::vector<int64_t> totals(n_threads, 0);
  std::vector<int32_t> finals(n_threads, kRoot);
  int64_t chunk = n / n_threads;
  int32_t s_in = *state_io;
  auto worker = [&](int64_t t) {
    ReaderScope scope(m);
    RView v;
    view_load(m, &v);
    int64_t start = t * chunk;
    int64_t end = (t == n_threads - 1) ? n : start + chunk;
    int32_t s;
    if (t == 0) {
      s = (s_in < 0 || s_in >= v.n) ? kRoot : s_in;
    } else {
      s = kRoot;
      for (int64_t i = std::max<int64_t>(0, start - halo); i < start; ++i)
        s = view_goto(m, &v, s, letters[i]);
    }
    int64_t tot = 0;
    for (int64_t i = start; i < end; ++i) {
      s = view_goto(m, &v, s, letters[i]);
      tot += ld_acq(&v.nb[s]);
    }
    totals[t] = tot;
    finals[t] = s;
  };
  std::vector<std::thread> workers;
  for (int64_t t = 1; t < n_threads; ++t) workers.emplace_back(worker, t);
  worker(0);
  for (auto& w : workers) w.join();
  int64_t total = 0;
  for (int64_t t = 0; t < n_threads; ++t) total += totals[t];
  *state_io = finals[n_threads - 1];
  return total;
}

// Threaded per-document batch count (the host analogue of
// DenseScanner.count_many): documents delimited by offsets (n_docs+1
// entries), each starting at the root. totals[d] receives document d's
// match count; end_states[d] (optional) its final cursor. Contiguous
// document ranges are balanced by total symbols across worker threads.
void acx_match_bulk_many(Machine* m, const int32_t* letters,
                         const int64_t* offsets, int64_t n_docs,
                         int64_t* totals, int32_t* end_states) {
  m->ensure_fail_states();
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw >= 2 ? std::max<int64_t>(2, hw / 2) : 1;
  int64_t n_sym = offsets[n_docs];
  if (n_docs < 2 * n_threads || n_sym < 262144) n_threads = 1;
  auto run_range = [&](int64_t lo, int64_t hi) {
    ReaderScope scope(m);
    RView v;
    view_load(m, &v);
    for (int64_t d = lo; d < hi; ++d) {
      int32_t s = kRoot;
      int64_t tot = 0;
      for (int64_t i = offsets[d]; i < offsets[d + 1]; ++i) {
        s = view_goto(m, &v, s, letters[i]);
        tot += ld_acq(&v.nb[s]);
      }
      totals[d] = tot;
      if (end_states) end_states[d] = s;
    }
  };
  if (n_threads <= 1) {
    run_range(0, n_docs);
    return;
  }
  // contiguous ranges, balanced by symbol mass
  std::vector<int64_t> bounds(n_threads + 1, n_docs);
  bounds[0] = 0;
  int64_t d = 0;
  for (int64_t t = 1; t < n_threads; ++t) {
    int64_t target = n_sym * t / n_threads;
    while (d < n_docs && offsets[d] < target) ++d;
    bounds[t] = d;
  }
  std::vector<std::thread> workers;
  for (int64_t t = 1; t < n_threads; ++t)
    workers.emplace_back(run_range, bounds[t], bounds[t + 1]);
  run_range(bounds[0], bounds[1]);
  for (auto& w : workers) w.join();
}

// ref acm_get_match chain walk (c:457-466); returns the index-th
// end-of-keyword state along the fail chain (kNoState if out of bounds).
// Lock-free: under a concurrent insertion the count and the end flags are
// published together, but a racing reader may transiently observe a count
// without the flags — the root guards below then return kNoState instead
// of walking past the root (the reference's unsynchronized walk has the
// same transient window).
int32_t acx_get_match_state(Machine* m, int32_t state, int64_t index) {
  m->ensure_fail_states();
  ReaderScope scope(m);
  RView v;
  view_load(m, &v);
  if (state < 0 || state >= v.n) return kNoState;
  if (index >= ld_acq(&v.nb[state])) return kNoState;
  int64_t i = 0;
  for (;;) {
    while (state != kRoot && !ld_acq(&v.ie[state]))
      state = view_fail(m, &v, state);
    if (!ld_acq(&v.ie[state])) return kNoState;  // reached root, no end
    if (i == index) return state;
    ++i;
    if (state == kRoot) return kNoState;
    state = view_fail(m, &v, state);
  }
}

// Introspection reads run without the lock (Python property accesses can
// race inserters) — atomic relaxed loads, momentarily-stale values.
int64_t acx_n_states(const Machine* m) {
  return static_cast<int64_t>(
      __atomic_load_n(&m->n_states_, __ATOMIC_RELAXED));
}
int64_t acx_nb_sequences(const Machine* m) {
  return __atomic_load_n(&m->nb_sequences, __ATOMIC_RELAXED);
}
int64_t acx_version(const Machine* m) {
  return __atomic_load_n(&m->version, __ATOMIC_RELAXED);
}
int64_t acx_reconstruct(const Machine* m) {
  return __atomic_load_n(&m->reconstruct, __ATOMIC_RELAXED);
}
int32_t acx_max_letter(const Machine* m) {
  return __atomic_load_n(&m->max_letter, __ATOMIC_RELAXED);
}
void acx_ensure_fail_states(Machine* m) { m->ensure_fail_states(); }

// Snapshot of per-state arrays (caller allocates n_states elements each;
// any pointer may be null to skip). Call acx_ensure_fail_states first in
// AC75 mode.
// n_limit caps the export to the caller's buffer size (state count can
// grow between sizing the buffers and this call under concurrency).
// nb_outputs and kw_rank are int64 internally but export as int32; a
// value past INT32_MAX would wrap silently — the
// export instead stops and returns 1 + the offending state id (0 = ok)
// so the binding can raise.
int64_t acx_export_arrays(Machine* m, int64_t n_limit, int32_t* fail,
                          int32_t* prev_state, int32_t* prev_letter,
                          uint8_t* is_end, int32_t* nb_outputs,
                          int32_t* depth, int32_t* kw_rank) {
  std::lock_guard<std::mutex> lock(m->token);
  size_t S = std::min<size_t>(m->n_states_, static_cast<size_t>(n_limit));
  for (size_t s = 0; s < S; ++s) {
    if (fail) fail[s] = (m->fail[s] == kNoState) ? kRoot : m->fail[s];
    if (prev_state) prev_state[s] = m->prev_state[s];
    if (prev_letter) prev_letter[s] = m->prev_letter[s];
    if (is_end) is_end[s] = m->is_end[s];
    if (nb_outputs) {
      if (m->nb_outputs[s] > INT32_MAX) return static_cast<int64_t>(s) + 1;
      nb_outputs[s] = static_cast<int32_t>(m->nb_outputs[s]);
    }
    if (depth) depth[s] = m->depth[s];
    if (kw_rank) {
      if (m->kw_rank[s] > INT32_MAX) return static_cast<int64_t>(s) + 1;
      kw_rank[s] = static_cast<int32_t>(m->kw_rank[s]);
    }
  }
  return 0;
}

// TEST-ONLY hook: force a state's int64 counters to arbitrary values so
// the export-narrowing guard above is exercisable at the int32 boundary
// (reaching >2^31 outputs/ranks organically would need >2^31 keywords).
// Leaves the automaton semantically inconsistent — never call outside
// tests.
void acx_debug_set_counts(Machine* m, int32_t state, int64_t nb,
                          int64_t rank) {
  // Runtime gate: inert unless the caller opted into the
  // testing surface — a production process that never sets ACX_TESTING
  // cannot corrupt a machine through this symbol.
  if (std::getenv("ACX_TESTING") == nullptr) {
    std::fprintf(stderr,
                 "acx_debug_set_counts: ignored (set ACX_TESTING=1 to "
                 "enable this test-only hook)\n");
    return;
  }
  std::lock_guard<std::mutex> lock(m->token);
  m->nb_outputs[state] = nb;
  m->kw_rank[state] = rank;
}

// Dense fail-collapsed transition table emission (the device upload):
// delta[s*V + a] = goto(s, a) with fail links resolved. BFS row-copy —
// fail[s] is always emitted before s.
void acx_emit_delta(Machine* m, int32_t V, int32_t* delta) {
  std::lock_guard<std::mutex> lock(m->token);
  m->ensure_fail_states_locked();
  std::vector<int32_t> order, child_start, child_list;
  m->depth_order(order);
  m->build_children(child_start, child_list);
  // Rows at equal depth are independent (each copies its fail row, which
  // is strictly shallower), so emit depth level by depth level with the
  // rows of a level split across threads — table emission is memcpy-bound
  // and parallelizes nearly linearly.
  auto emit_row = [&](int32_t s) {
    int32_t* row = delta + static_cast<int64_t>(s) * V;
    if (s == kRoot) {
      std::memset(row, 0, sizeof(int32_t) * V);
    } else {
      const int32_t* frow = delta + static_cast<int64_t>(m->fail[s]) * V;
      std::memcpy(row, frow, sizeof(int32_t) * V);
    }
    for (int32_t e = child_start[s]; e < child_start[s + 1]; ++e) {
      int32_t child = child_list[e];
      if (m->prev_letter[child] < V) row[m->prev_letter[child]] = child;
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  size_t n_threads = hw >= 4 ? hw / 2 : (hw ? hw : 1);
  size_t S = order.size();
  size_t level_start = 0;
  while (level_start < S) {
    int32_t d = m->depth[order[level_start]];
    size_t level_end = level_start;
    while (level_end < S && m->depth[order[level_end]] == d) ++level_end;
    size_t n = level_end - level_start;
    if (n < 4096 || n_threads <= 1) {
      for (size_t i = level_start; i < level_end; ++i) emit_row(order[i]);
    } else {
      size_t per = (n + n_threads - 1) / n_threads;
      std::vector<std::thread> workers;
      for (size_t t = 0; t < n_threads; ++t) {
        size_t lo = level_start + t * per;
        size_t hi = std::min(level_end, lo + per);
        if (lo >= hi) break;
        workers.emplace_back([&, lo, hi] {
          for (size_t i = lo; i < hi; ++i) emit_row(order[i]);
        });
      }
      for (auto& w : workers) w.join();
    }
    level_start = level_end;
  }
}

// Fail-chain emit lists as CSR (the device-side replacement for
// acm_get_match's runtime fail-chain walk, reference c:457-466): for every
// state, the end-of-keyword states along its fail chain, self (longest)
// first. emit_start is the caller-computed exclusive prefix sum of
// nb_outputs (n_limit+1 entries, sized from the SNAPSHOT the caller
// exported earlier); emit_state (emit_start[n_limit] entries) is filled
// here. Depth order guarantees emit_state[fail[s]]'s list is final before
// s copies it — same argument as acx_emit_delta's row copies.
//
// Every write is clamped to the caller's CSR geometry (n_limit states,
// per-state slot widths from emit_start): if the builder advanced between
// the snapshot export and this call — only possible when bypassing the
// Machine-level lock — the output may be stale but never out of bounds.
void acx_emit_csr(Machine* m, int64_t n_limit, const int32_t* emit_start,
                  int32_t* emit_state) {
  std::lock_guard<std::mutex> lock(m->token);
  m->ensure_fail_states_locked();
  std::vector<int32_t> order;
  m->depth_order(order);
  for (int32_t s : order) {
    if (s >= n_limit) continue;
    int64_t slot = emit_start[s + 1] - emit_start[s];
    if (slot <= 0) continue;
    int64_t n = std::min<int64_t>(m->nb_outputs[s], slot);
    int32_t base = emit_start[s];
    int32_t f = (m->fail[s] == kNoState) ? kRoot : m->fail[s];
    int64_t fslot = (f < n_limit) ? emit_start[f + 1] - emit_start[f] : 0;
    int64_t own = m->is_end[s] ? 1 : 0;
    if (own) emit_state[base] = s;
    int64_t n_copy = std::min<int64_t>(n - own, fslot);
    if (n_copy > 0)
      std::memcpy(emit_state + base + own, emit_state + emit_start[f],
                  sizeof(int32_t) * n_copy);
    // Stale-geometry remainder (unreachable under the Machine lock):
    // fill with s so every slot the snapshot's nb_outputs covers holds a
    // valid state id.
    for (int64_t i = own + std::max<int64_t>(n_copy, 0); i < slot; ++i)
      emit_state[base + i] = s;
  }
}

// Trie edge dump in BFS order for Python-side introspection:
// parents/letters/children each sized acx_n_edges().
int64_t acx_n_edges(const Machine* m) {
  return static_cast<int64_t>(m->n_states_) - 1;
}

// n_limit caps the export to the caller's buffer size (see
// acx_export_arrays).
void acx_export_edges(Machine* m, int64_t n_limit, int32_t* parents,
                      int32_t* letters, int32_t* children) {
  std::lock_guard<std::mutex> lock(m->token);
  // Every non-root state has exactly one incoming edge.
  size_t S = std::min<size_t>(m->n_states_,
                              static_cast<size_t>(n_limit) + 1);
  int64_t e = 0;
  for (size_t s = 1; s < S; ++s, ++e) {
    parents[e] = m->prev_state[s];
    letters[e] = m->prev_letter[s];
    children[e] = static_cast<int32_t>(s);
  }
}

// Keyword letters of the state's incoming path, written backwards-then-
// reversed into buf (cap letters max); returns the keyword length.
int64_t acx_keyword_letters(Machine* m, int32_t state, int32_t* buf,
                            int64_t cap) {
  std::lock_guard<std::mutex> lock(m->token);
  int64_t n = 0;
  for (int32_t s = state; s != kRoot && m->prev_state[s] != kNoState;
       s = m->prev_state[s])
    ++n;
  int64_t i = n < cap ? n : cap;
  for (int32_t s = state; i > 0 && m->prev_state[s] != kNoState;
       s = m->prev_state[s])
    buf[--i] = m->prev_letter[s];
  return n;
}

int64_t acx_kw_rank(Machine* m, int32_t state) {
  std::lock_guard<std::mutex> lock(m->token);
  return m->kw_rank[state];
}

void acx_set_version(Machine* m, int64_t v) {
  std::lock_guard<std::mutex> lock(m->token);
  st_rlx(&m->version, v);
}

// Largest representable dense letter id (edge_key packs letters in
// kLetterBits bits; callers must reject larger ids).
int32_t acx_max_letter_id(void) { return (1 << kLetterBits) - 1; }

}  // extern "C"
