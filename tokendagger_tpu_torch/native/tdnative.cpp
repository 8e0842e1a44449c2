// tokendagger_tpu_torch native host runtime: the JAX package's
// native/tdnative.cpp, with td_encode's per-piece body drawn out into
// piece_ids and td_splice added on it.
//
// C++ implementations of the host-side hot paths, mirroring the role of the
// reference tokenizer's C++ engine (src/tiktoken/tiktoken.cpp — design
// studied, code written fresh for this architecture):
//
//   * td_scan    — pretokenizer over UTF-8 bytes, same class-run algorithm
//                  as scanner_ref.py / ops/pretokenize.py (the fuzz-verified
//                  decomposition of the tiktoken pattern family into
//                  per-alternative greedy matchers).
//   * td_encode  — scan + exact sequential BPE merge, emitting token ids.
//                  The merge is keyed by *token-id pairs* against the same
//                  two-choice bucketed hash table the device kernels use
//                  (tables.py), so host and device share one compiled vocab
//                  artifact and one hash function.
//   * td_splice  — td_encode's per-piece resolution for the pieces a
//                  device window missed, spliced into the window's ids.
//
// All entry points are plain C ABI for ctypes; they hold no GIL and no
// global state, so Python ThreadPoolExecutor fan-out scales across cores
// (the reference's thread-DP model, wrapper.py:234-235 / py_binding.cpp:26).
//
// Build: g++ -O3 -march=native -shared -fPIC tdnative.cpp -o tdnative.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int32_t MAX_RANK = 0x7FFFFFFF;

// class bits (must match unicode_tables.py)
constexpr uint8_t WS = 0x01;
constexpr uint8_t RN = 0x02;
constexpr uint8_t LETTER = 0x04;
constexpr uint8_t NUM = 0x08;
constexpr uint8_t UC = 0x10;
constexpr uint8_t LC = 0x20;
// Han (\p{Han}), in the kimi profile's table (unicode_tables.kimi_classes),
// which also has no UC or LC on Han
constexpr uint8_t HAN = 0x40;

// fold-letter ids (must match scanner_ref._FOLD_ORDER = "strevmld")
enum FoldId : int8_t { F_S = 0, F_T, F_R, F_E, F_V, F_M, F_L, F_D };

struct VocabSlot {  // 12 bytes: keeps the table L2/L3-resident
  uint32_t fp;       // hash fingerprint; 0 = empty slot
  uint32_t off_len;  // (off << 8) | len ; blob <= 16 MB, token <= 255 B
  int32_t rank;
};

struct Tables {
  const uint8_t* classes;    // 0x110000
  const int8_t* fold;       // 0x110000
  const int32_t* pair_rows;  // (nbuckets, 12)
  int64_t nbuckets;
  uint32_t mask;
  const int32_t* byte_rank;  // 256
  int contractions;
  // unique engine id: memo-cache ownership must not be keyed by pointer
  // identity (a freed engine's address can be reused; see g_memo)
  uint64_t gen = 0;
  // whole-piece vocab hash (optional; reference fast path
  // src/tiktoken/tiktoken.cpp:210-215)
  std::vector<VocabSlot> vocab;
  uint64_t vocab_mask = 0;
  const uint8_t* keys_blob = nullptr;
  // byte-pair LUT: rank of the 2-byte token (b0,b1), MAX_RANK if absent.
  // Covers every lookup of the merge's init pass (all parts are bytes) in
  // 256 KB of cache instead of the big id-pair hash.
  std::vector<int32_t> pair_lut;  // 256*256
  // special-token scanner (byte-space): leading-bigram/first-byte bitmaps
  // + first-4-byte bucket dispatch, mirroring
  // hostengine.find_all_specials semantics (itself the single-pass form
  // of the reference's cached per-token find loop, tiktoken.cpp:130-154).
  // Candidates resolve by walking ONLY the specials sharing their first
  // 4 bytes (length-descending), not every distinct length — the
  // all-lengths FNV form measured 0.4 µs per special-dense candidate.
  // Installed by td_set_specials.
  struct SpEntry {
    uint32_t off;   // blob offset
    int32_t len;
    int32_t id;
    int32_t next;   // chain, length-descending
  };
  struct Sp4Slot {
    uint32_t key;   // first 4 bytes (LE)
    int32_t head;   // entry index, -1 = empty slot
  };
  std::vector<uint64_t> sp_big;       // 65536-bit leading-bigram bitmap
  uint64_t sp_one[4] = {0, 0, 0, 0};  // 256-bit 1-byte-special bitmap
  std::vector<SpEntry> sp_entries;    // specials with len >= 4
  std::vector<Sp4Slot> sp_map4;       // open-addressing first4 -> chain
  uint64_t sp_map4_mask = 0;
  std::vector<SpEntry> sp_short;      // len < 4, length-descending
  const uint8_t* sp_blob = nullptr;
  bool sp_ready = false;
  // the specials' distinct first bytes where they are at most
  // kSpFirstMax (the scan skips to the nearest with memchr), else empty
  std::vector<uint8_t> sp_firsts;
};

// most distinct first bytes of the specials that td_find_specials_l skips
// to with one memchr each (kimi's 256 specials start with '<' or '[')
constexpr size_t kSpFirstMax = 4;

// scanner profiles, carried in Tables.contractions (backwards compatible:
// 0/1 keep their original off/on meaning for the o200k family)
// P_KIMI: llama4's alternatives after a Han-run alternative, over the
// kimi table, with the punctuation tail [\r\n]*
enum Profile : int {
  P_NOCONTRACT = 0, P_LLAMA4 = 1, P_CL100K = 2, P_GPT2 = 3, P_KIMI = 4
};

inline uint64_t fnv1a(const uint8_t* p, int64_t n) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t i = 0; i < n; ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

inline int32_t vocab_lookup_h(const Tables* t, const uint8_t* p, int64_t n,
                              uint64_t h) {
  if (!t->vocab_mask || n > 255) return -1;
  uint32_t fp = (uint32_t)(h >> 32) | 1u;  // nonzero fingerprint
  uint64_t i = h & t->vocab_mask;
  for (;;) {
    const VocabSlot& s = t->vocab[i];
    if (s.fp == 0) return -1;
    if (s.fp == fp && (s.off_len & 0xFF) == (uint32_t)n &&
        std::memcmp(t->keys_blob + (s.off_len >> 8), p, n) == 0)
      return s.rank;
    i = (i + 1) & t->vocab_mask;
  }
}

inline int32_t vocab_lookup(const Tables* t, const uint8_t* p, int64_t n) {
  if (!t->vocab_mask || n > 255) return -1;
  return vocab_lookup_h(t, p, n, fnv1a(p, n));
}

// -------------------------------------------------------------------------
// Per-thread memo of piece -> token ids. Natural text repeats a small set
// of vocab-missing pieces over and over (capitalized words, space-prefixed
// forms, foreign words); memoizing their merge result collapses the merge
// cost to a probe + memcpy. Keyed by the FNV hash already computed for the
// vocab fast path; exact (keys byte-compared in the arena).
// -------------------------------------------------------------------------
struct MemoEntry {
  uint64_t fp = 0;     // full hash; 0 = empty
  uint32_t key_off = 0;
  uint32_t ids_off = 0;
  uint16_t len = 0;
  uint16_t n_ids = 0;
};

struct MemoCache {
  uint64_t owner = 0;  // Tables::gen of the engine this cache belongs to
  std::vector<MemoEntry> slots;
  std::vector<uint8_t> key_arena;
  std::vector<int32_t> id_arena;

  static constexpr size_t N_SLOTS = 1 << 16;
  static constexpr size_t MAX_ARENA = 4u << 20;

  void reset(uint64_t own) {
    owner = own;
    slots.assign(N_SLOTS, MemoEntry{});
    key_arena.clear();
    id_arena.clear();
  }

  const MemoEntry* find(uint64_t h, const uint8_t* p, int64_t n) const {
    const MemoEntry& e = slots[h & (N_SLOTS - 1)];
    if (e.fp == h && e.len == n &&
        std::memcmp(key_arena.data() + e.key_off, p, n) == 0)
      return &e;
    return nullptr;
  }

  void insert(uint64_t h, const uint8_t* p, int64_t n, const int32_t* ids,
              int64_t n_ids) {
    if (n > 0xFFFF || n_ids > 0xFFFF) return;
    if (key_arena.size() + n > MAX_ARENA ||
        id_arena.size() + n_ids > MAX_ARENA) {
      // arena full: drop everything (simple, rare)
      slots.assign(N_SLOTS, MemoEntry{});
      key_arena.clear();
      id_arena.clear();
    }
    MemoEntry& e = slots[h & (N_SLOTS - 1)];
    e.fp = h;
    e.key_off = (uint32_t)key_arena.size();
    e.ids_off = (uint32_t)id_arena.size();
    e.len = (uint16_t)n;
    e.n_ids = (uint16_t)n_ids;
    key_arena.insert(key_arena.end(), p, p + n);
    id_arena.insert(id_arena.end(), ids, ids + n_ids);
  }
};

thread_local MemoCache g_memo;

// ---------------------------------------------------------------------------
// pair-table lookup (bit-identical to tables._mix_hash / ops.merge._mix)
// ---------------------------------------------------------------------------
inline uint32_t mix(uint32_t a, uint32_t b, uint32_t c1, uint32_t c2,
                    uint32_t c3, uint32_t mask) {
  uint32_t h = a * c1 + b * c2;
  h ^= h >> 16;
  h *= c3;
  h ^= h >> 15;
  return h & mask;
}

inline int32_t pair_lookup(const Tables* t, int32_t a, int32_t b) {
  if (a < 0 || b < 0) return MAX_RANK;
  static const uint32_t M[2][3] = {{0x9E3779B1u, 0x85EBCA77u, 0x7FEB352Du},
                                   {0xC2B2AE3Du, 0x27D4EB2Fu, 0x165667B1u}};
  for (int which = 0; which < 2; ++which) {
    uint32_t h = mix((uint32_t)a, (uint32_t)b, M[which][0], M[which][1],
                     M[which][2], t->mask);
    const int32_t* row = t->pair_rows + (int64_t)h * 12;
    for (int s = 0; s < 4; ++s) {
      if (row[s] == a && row[4 + s] == b) return row[8 + s];
    }
  }
  return MAX_RANK;
}

// ---------------------------------------------------------------------------
// Byte-level scanner: match length in BYTES at a byte position, decoding
// UTF-8 on the fly (no char-array materialization, no allocations).
// Logic mirrors scanner_ref.py's per-alternative derivation exactly.
// ---------------------------------------------------------------------------
struct BScan {
  const Tables* t;
  const uint8_t* end;

  // decode char at p (assumed valid UTF-8; truncated tails decode as the
  // lead byte alone, matching Python str encoding invariants)
  inline const uint8_t* dec(const uint8_t* p, int32_t* cp) const {
    uint8_t b = p[0];
    if (b < 0x80) {
      *cp = b;
      return p + 1;
    }
    if (b < 0xE0 && p + 1 < end) {
      *cp = ((b & 0x1F) << 6) | (p[1] & 0x3F);
      return p + 2;
    }
    if (b < 0xF0 && p + 2 < end) {
      *cp = ((b & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
      return p + 3;
    }
    if (p + 3 < end) {
      int32_t c = ((b & 0x07) << 18) | ((p[1] & 0x3F) << 12) |
                  ((p[2] & 0x3F) << 6) | (p[3] & 0x3F);
      *cp = c < 0x110000 ? c : 0;
      return p + 4;
    }
    *cp = b < 0x80 ? b : 0;
    return p + 1;
  }

  inline uint8_t cls(int32_t cp) const { return t->classes[cp]; }

  // fused [UC]*[LC]+ / [UC]+[LC]* matcher at q.
  // Returns match end (nullptr if none); *isA1 says which alternative.
  const uint8_t* word(const uint8_t* q, bool* isA1) const {
    const uint8_t* p = q;
    const uint8_t* last_lc_end = nullptr;
    // phase 1: UC prefix (tracking overlap chars that are also LC)
    while (p < end) {
      int32_t c;
      const uint8_t* np = dec(p, &c);
      uint8_t k = cls(c);
      if (!(k & UC)) break;
      p = np;
      if (k & LC) last_lc_end = np;
    }
    const uint8_t* p_end = p;
    // phase 2: LC continuation
    bool found = false;
    while (p < end) {
      int32_t c;
      const uint8_t* np = dec(p, &c);
      if (!(cls(c) & LC)) break;
      p = np;
      found = true;
    }
    if (found) {
      *isA1 = true;
      return p;  // [UC-prefix][LC-run]
    }
    if (last_lc_end) {
      *isA1 = true;  // all-UC run: backtrack to last UC&LC overlap char
      return last_lc_end;
    }
    if (p_end > q) {
      *isA1 = false;  // pure-UC run: [UC]+[LC]* with empty LC*
      return p_end;
    }
    return nullptr;
  }

  // contraction suffix end at e ('s|'t|'re|'ve|'m|'ll|'d, case-folded)
  inline const uint8_t* ct(const uint8_t* e) const {
    if ((t->contractions != P_LLAMA4 && t->contractions != P_KIMI) ||
        e >= end || *e != '\'')
      return e;
    const uint8_t* p = e + 1;
    if (p >= end) return e;
    int32_t c1;
    const uint8_t* p2 = dec(p, &c1);
    int8_t f1 = t->fold[c1];
    if (f1 == F_S || f1 == F_T || f1 == F_M || f1 == F_D) return p2;
    if ((f1 == F_R || f1 == F_V || f1 == F_L) && p2 < end) {
      int32_t c2;
      const uint8_t* p3 = dec(p2, &c2);
      int8_t f2 = t->fold[c2];
      if (((f1 == F_R || f1 == F_V) && f2 == F_E) ||
          (f1 == F_L && f2 == F_L))
        return p3;
    }
    return e;
  }

  // cl100k profile match (see scanner_ref._match_lengths_cl100k):
  //   '(?i:[sdmt]|ll|ve|re) | [^\r\n\p{L}\p{N}]?+\p{L}+ | \p{N}{1,3}
  //   | ' '?[^\s\p{L}\p{N}]++[\r\n]* | \s*[\r\n] | \s+(?!\S) | \s+
  const uint8_t* match_end_cl100k(const uint8_t* p) const {
    int32_t c0;
    const uint8_t* p1ptr = dec(p, &c0);
    uint8_t k0 = cls(c0);

    // C1: leading-apostrophe contraction
    if (c0 == '\'' && p1ptr < end) {
      int32_t c1v;
      const uint8_t* p2 = dec(p1ptr, &c1v);
      int8_t f1 = t->fold[c1v];
      if (f1 == F_S || f1 == F_D || f1 == F_M || f1 == F_T) return p2;
      if ((f1 == F_L || f1 == F_V || f1 == F_R) && p2 < end) {
        int32_t c2v;
        const uint8_t* p3 = dec(p2, &c2v);
        int8_t f2 = t->fold[c2v];
        if ((f1 == F_L && f2 == F_L) || (f1 == F_V && f2 == F_E) ||
            (f1 == F_R && f2 == F_E))
          return p3;
      }
    }

    // C2: possessive prefix + \p{L}+
    {
      const uint8_t* q = nullptr;
      if (!(k0 & (RN | LETTER | NUM)))
        q = p1ptr;  // prefix consumed possessively
      else if (k0 & LETTER)
        q = p;
      if (q) {
        const uint8_t* e = q;
        while (e < end) {
          int32_t c;
          const uint8_t* ne = dec(e, &c);
          if (!(cls(c) & LETTER)) break;
          e = ne;
        }
        if (e > q) return e;
        // possessive: a consumed prefix without letters does NOT retry;
        // fall through to the remaining alternatives
      }
    }

    // C3: \p{N}{1,3}
    if (k0 & NUM) {
      const uint8_t* q = p1ptr;
      for (int i = 1; i < 3 && q < end; ++i) {
        int32_t c;
        const uint8_t* nq = dec(q, &c);
        if (!(cls(c) & NUM)) break;
        q = nq;
      }
      return q;
    }

    // C4: ' '? [^\s\p{L}\p{N}]++ [\r\n]*
    {
      const uint8_t* q = nullptr;
      if (c0 == ' ')
        q = p1ptr;
      else if (!(k0 & (WS | LETTER | NUM)))
        q = p;
      if (q) {
        const uint8_t* e = q;
        while (e < end) {
          int32_t c;
          const uint8_t* ne = dec(e, &c);
          if ((cls(c) & (WS | LETTER | NUM))) break;
          e = ne;
        }
        if (e > q) {
          while (e < end && (*e == '\r' || *e == '\n')) ++e;
          return e;
        }
      }
    }

    // C5/C6/C7: whitespace family (same closed forms as the o200k family)
    if (k0 & WS) {
      const uint8_t* q = p;
      const uint8_t* prev_start = p;
      const uint8_t* last_rn_end = nullptr;
      while (q < end) {
        int32_t c;
        const uint8_t* nq = dec(q, &c);
        if (!(cls(c) & WS)) break;
        prev_start = q;
        if (c == '\r' || c == '\n') last_rn_end = nq;
        q = nq;
      }
      if (last_rn_end) return last_rn_end;
      if (q == end) return q;
      if (prev_start > p) return prev_start;
      return q;
    }

    return p1ptr;  // safety
  }

  // gpt2 / r50k / p50k profile: '(?:[sdmt]|ll|ve|re) (case-sensitive)
  //   | ' '?\p{L}+ | ' '?\p{N}+ | ' '?[^\s\p{L}\p{N}]+ | \s+(?!\S) | \s+
  const uint8_t* match_end_gpt2(const uint8_t* p) const {
    int32_t c0;
    const uint8_t* p1ptr = dec(p, &c0);
    uint8_t k0 = cls(c0);

    // G1: case-sensitive contraction
    if (c0 == '\'' && p1ptr < end) {
      uint8_t c1 = *p1ptr;
      if (c1 == 's' || c1 == 'd' || c1 == 'm' || c1 == 't') return p1ptr + 1;
      if (p1ptr + 1 < end) {
        uint8_t c2 = p1ptr[1];
        if ((c1 == 'l' && c2 == 'l') || (c1 == 'v' && c2 == 'e') ||
            (c1 == 'r' && c2 == 'e'))
          return p1ptr + 2;
      }
    }

    // G2..G4: optional space + single class run
    for (uint8_t bit : {LETTER, NUM}) {
      const uint8_t* q = nullptr;
      if (c0 == ' ')
        q = p1ptr;
      else if (k0 & bit)
        q = p;
      if (q) {
        const uint8_t* e = q;
        while (e < end) {
          int32_t c;
          const uint8_t* ne = dec(e, &c);
          if (!(cls(c) & bit)) break;
          e = ne;
        }
        if (e > q) return e;
      }
    }
    {  // punct run: [^\s\p{L}\p{N}]
      const uint8_t* q = nullptr;
      if (c0 == ' ')
        q = p1ptr;
      else if (!(k0 & (WS | LETTER | NUM)))
        q = p;
      if (q) {
        const uint8_t* e = q;
        while (e < end) {
          int32_t c;
          const uint8_t* ne = dec(e, &c);
          if ((cls(c) & (WS | LETTER | NUM))) break;
          e = ne;
        }
        if (e > q) return e;
      }
    }

    // G5/G6: whitespace
    if (k0 & WS) {
      const uint8_t* q = p;
      const uint8_t* prev_start = p;
      while (q < end) {
        int32_t c;
        const uint8_t* nq = dec(q, &c);
        if (!(cls(c) & WS)) break;
        prev_start = q;
        q = nq;
      }
      if (q == end) return q;
      if (prev_start > p) return prev_start;
      return q;
    }

    return p1ptr;  // safety
  }

  // match end (byte pointer) for the match starting at p (p < end)
  const uint8_t* match_end(const uint8_t* p) const {
    if (t->contractions == P_CL100K) return match_end_cl100k(p);
    if (t->contractions == P_GPT2) return match_end_gpt2(p);
    int32_t c0;
    const uint8_t* p1ptr = dec(p, &c0);
    uint8_t k0 = cls(c0);

    // kimi: [\p{Han}]+ first
    if (k0 & HAN) {
      const uint8_t* e = p1ptr;
      while (e < end) {
        int32_t c;
        const uint8_t* ne = dec(e, &c);
        if (!(cls(c) & HAN)) break;
        e = ne;
      }
      return e;
    }

    // word alternatives (A1 before A2; prefix-greedy within each)
    bool pfx_ok = !(k0 & (RN | LETTER | NUM));
    const uint8_t* wpre = nullptr;
    bool wpreA1 = false;
    if (pfx_ok && p1ptr < end) wpre = word(p1ptr, &wpreA1);
    if (wpre && wpreA1) return ct(wpre);
    if (k0 & (UC | LC)) {
      bool a1;
      const uint8_t* w = word(p, &a1);
      if (w && a1) return ct(w);
      if (wpre) return ct(wpre);  // A2 with prefix
      if (w) return ct(w);        // A2 without prefix
    } else if (wpre) {
      return ct(wpre);  // A2 with prefix (start char not word-class)
    }

    // A3: \p{N}{1,3}
    if (k0 & NUM) {
      const uint8_t* q = p1ptr;
      for (int i = 1; i < 3 && q < end; ++i) {
        int32_t c;
        const uint8_t* nq = dec(q, &c);
        if (!(cls(c) & NUM)) break;
        q = nq;
      }
      return q;
    }

    // A4: ' '? [^\s\p{L}\p{N}]+ [\r\n/]*
    {
      const uint8_t* q = nullptr;
      if (c0 == ' ')
        q = p1ptr;
      else if (!(k0 & (WS | LETTER | NUM)))
        q = p;
      if (q) {
        const uint8_t* e = q;
        while (e < end) {
          int32_t c;
          const uint8_t* ne = dec(e, &c);
          uint8_t k = cls(c);
          if ((k & (WS | LETTER | NUM))) break;
          e = ne;
        }
        if (e > q) {
          const bool slash = t->contractions != P_KIMI;
          while (e < end &&
                 (*e == '\r' || *e == '\n' || (slash && *e == '/')))
            ++e;
          return e;
        }
        // space with no punct after: fall through to whitespace family
      }
    }

    // A5/A6/A7: whitespace family
    if (k0 & WS) {
      const uint8_t* q = p;
      const uint8_t* prev_start = p;       // start of last ws char
      const uint8_t* last_rn_end = nullptr;
      while (q < end) {
        int32_t c;
        const uint8_t* nq = dec(q, &c);
        if (!(cls(c) & WS)) break;
        prev_start = q;
        if (c == '\r' || c == '\n') last_rn_end = nq;
        q = nq;
      }
      if (last_rn_end) return last_rn_end;  // A5
      if (q == end) return q;               // A6 at end-of-text
      if (prev_start > p) return prev_start;  // A6: hold back last ws char
      return q;                             // A7 (single ws char)
    }

    return p1ptr;  // safety: consume one char (unreachable for the family)
  }
};

struct Workspace {
  std::vector<int32_t> rank;
  std::vector<int32_t> nxt;
  std::vector<int32_t> prv;
  std::vector<int32_t> start;
};

}  // namespace

extern "C" {

void* td_create(const uint8_t* classes, const int8_t* fold,
                const int32_t* pair_rows, int64_t nbuckets, int32_t mask,
                const int32_t* byte_rank, int contractions) {
  static std::atomic<uint64_t> next_gen{1};
  Tables* t = new Tables();
  t->classes = classes;
  t->fold = fold;
  t->pair_rows = pair_rows;
  t->nbuckets = nbuckets;
  t->mask = (uint32_t)mask;
  t->byte_rank = byte_rank;
  t->contractions = contractions;
  t->gen = next_gen.fetch_add(1);
  return t;
}

void td_destroy(void* h) { delete (Tables*)h; }

// Install the whole-piece vocab hash: keys_blob holds all token byte
// strings concatenated; offs/lens/ranks are parallel arrays of length n.
// The blob pointer is borrowed — caller keeps it alive. The packed slot
// layout addresses 24-bit blob offsets; vocabs whose concatenated bytes
// exceed 16 MB cannot be installed (the engine then reports -2 from
// encode and callers fall back to the exact Python path).
void td_set_vocab(void* h, const uint8_t* keys_blob, const int64_t* offs,
                  const int32_t* lens, const int32_t* ranks, int64_t n) {
  Tables* t = (Tables*)h;
  if (n > 0 && (uint64_t)(offs[n - 1] + lens[n - 1]) > (1u << 24)) {
    return;  // blob too large for the 24-bit offset packing
  }
  uint64_t cap = 1;
  while (cap < (uint64_t)(n * 2)) cap <<= 1;
  t->vocab.assign(cap, VocabSlot{0, 0, 0});
  t->vocab_mask = cap - 1;
  t->keys_blob = keys_blob;
  t->pair_lut.assign(256 * 256, MAX_RANK);
  for (int64_t i = 0; i < n; ++i) {
    if (lens[i] > 255) continue;  // not addressable by the fast path
    uint64_t hh = fnv1a(keys_blob + offs[i], lens[i]);
    uint32_t fp = (uint32_t)(hh >> 32) | 1u;
    uint64_t j = hh & t->vocab_mask;
    while (t->vocab[j].fp != 0) j = (j + 1) & t->vocab_mask;
    t->vocab[j] =
        VocabSlot{fp, ((uint32_t)offs[i] << 8) | (uint32_t)lens[i], ranks[i]};
    if (lens[i] == 2) {
      const uint8_t* k = keys_blob + offs[i];
      t->pair_lut[(size_t)k[0] * 256 + k[1]] = ranks[i];
    }
  }
}

// Install the special-token scan table: blob holds every special token's
// UTF-8 bytes concatenated; offs/lens/ids are parallel arrays of length n
// (ids = the special RANKS). Borrowed blob, same 24-bit-offset packing as
// td_set_vocab. Silently not installed (td_find_specials_l then returns -3,
// caller keeps the Python scan) when a token is empty/>255 B or the blob
// exceeds 16 MB.
void td_set_specials(void* h, const uint8_t* blob, const int64_t* offs,
                     const int32_t* lens, const int32_t* ids, int64_t n) {
  Tables* t = (Tables*)h;
  t->sp_ready = false;
  if (n <= 0) return;
  if ((uint64_t)(offs[n - 1] + lens[n - 1]) > (1u << 24)) return;
  for (int64_t i = 0; i < n; ++i)
    if (lens[i] < 1 || lens[i] > 255) return;
  t->sp_big.assign(1024, 0);
  t->sp_one[0] = t->sp_one[1] = t->sp_one[2] = t->sp_one[3] = 0;
  t->sp_blob = blob;
  t->sp_entries.clear();
  t->sp_short.clear();
  uint64_t cap = 4;
  while (cap < (uint64_t)(n * 2)) cap <<= 1;
  t->sp_map4.assign(cap, Tables::Sp4Slot{0, -1});
  t->sp_map4_mask = cap - 1;
  std::vector<uint8_t> firsts;
  // ascending-length insert + push-front chains => every chain walks
  // length-DESCENDING (the longest-at-tie selection order)
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return lens[a] < lens[b];
  });
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t i = order[oi];
    const uint8_t* k = blob + offs[i];
    if (lens[i] == 1) {
      t->sp_one[k[0] >> 6] |= 1ull << (k[0] & 63);
    } else {
      uint32_t bg = ((uint32_t)k[0] << 8) | k[1];
      t->sp_big[bg >> 6] |= 1ull << (bg & 63);
    }
    if (std::find(firsts.begin(), firsts.end(), k[0]) == firsts.end())
      firsts.push_back(k[0]);
    Tables::SpEntry e{(uint32_t)offs[i], lens[i], ids[i], -1};
    if (lens[i] < 4) {
      t->sp_short.insert(t->sp_short.begin(), e);  // keep descending
      continue;
    }
    uint32_t key;
    std::memcpy(&key, k, 4);
    uint64_t j = (key * 0x9E3779B1u) & t->sp_map4_mask;
    while (t->sp_map4[j].head >= 0 && t->sp_map4[j].key != key)
      j = (j + 1) & t->sp_map4_mask;
    e.next = t->sp_map4[j].head >= 0 ? t->sp_map4[j].head : -1;
    t->sp_entries.push_back(e);
    t->sp_map4[j] = Tables::Sp4Slot{key, (int32_t)t->sp_entries.size() - 1};
  }
  if (firsts.size() > kSpFirstMax) firsts.clear();
  t->sp_firsts = firsts;
  t->sp_ready = true;
}

// Scan for ALL installed specials (the allowed == full-set case; subsets
// keep the Python scan) with hostengine.find_all_specials semantics:
// leftmost match wins, same-position ties go to the longest token,
// matches never overlap. (Same-position ties require one special to be
// a strict byte-prefix of another — no real vocab has these; see the
// tie-break caveat on find_all_specials.) Writes (byte_pos, id) pairs
// (+ byte lengths when out_len is non-null); returns the count, -1 if
// cap is too small, -3 if no table installed.
int64_t td_find_specials_l(const void* h, const uint8_t* data, int64_t n,
                           int64_t* out_pos, int32_t* out_id,
                           int32_t* out_len, int64_t cap) {
  const Tables* t = (const Tables*)h;
  if (!t->sp_ready) return -3;
  const bool has1 =
      (t->sp_one[0] | t->sp_one[1] | t->sp_one[2] | t->sp_one[3]) != 0;
  int64_t cnt = 0;
  int64_t i = 0;
  // few distinct first bytes (one for the "<|...|>" family): a vectorized
  // skip to the nearest next occurrence of any of them; next[k] is the
  // next occurrence of sp_firsts[k] at or after the last search (n: none)
  const size_t nf = t->sp_firsts.size();
  int64_t next[kSpFirstMax];
  for (size_t k = 0; k < nf; ++k) next[k] = -1;
  while (i < n) {
    if (nf) {
      int64_t best = n;
      for (size_t k = 0; k < nf; ++k) {
        if (next[k] < i) {
          const void* p =
              std::memchr(data + i, t->sp_firsts[k], (size_t)(n - i));
          next[k] = p ? (const uint8_t*)p - data : n;
        }
        best = next[k] < best ? next[k] : best;
      }
      if (best >= n) break;
      i = best;
    }
    bool cand = false;
    if (i + 1 < n) {
      uint32_t bg = ((uint32_t)data[i] << 8) | data[i + 1];
      cand = (t->sp_big[bg >> 6] >> (bg & 63)) & 1;
    }
    if (!cand && has1) cand = (t->sp_one[data[i] >> 6] >> (data[i] & 63)) & 1;
    if (cand) {
      int32_t m_len = 0, m_id = 0;
      // >= 4-byte specials sharing this position's first 4 bytes,
      // walked length-descending (first 4 bytes known equal => memcmp
      // only the tail). All of these outrank any short special at the
      // same position, so order is exactly longest-first.
      if (i + 4 <= n) {
        uint32_t key;
        std::memcpy(&key, data + i, 4);
        uint64_t j = (key * 0x9E3779B1u) & t->sp_map4_mask;
        while (t->sp_map4[j].head >= 0 && t->sp_map4[j].key != key)
          j = (j + 1) & t->sp_map4_mask;
        if (t->sp_map4[j].head >= 0) {
          for (int32_t e = t->sp_map4[j].head; e >= 0;
               e = t->sp_entries[e].next) {
            const Tables::SpEntry& s = t->sp_entries[e];
            if (i + s.len <= n &&
                (s.len == 4 ||
                 std::memcmp(t->sp_blob + s.off + 4, data + i + 4,
                             (size_t)(s.len - 4)) == 0)) {
              m_len = s.len;
              m_id = s.id;
              break;
            }
          }
        }
      }
      if (m_len == 0) {
        for (const Tables::SpEntry& s : t->sp_short) {
          if (i + s.len <= n &&
              std::memcmp(t->sp_blob + s.off, data + i, (size_t)s.len) == 0) {
            m_len = s.len;
            m_id = s.id;
            break;
          }
        }
      }
      if (m_len) {
        if (cnt >= cap) return -1;
        out_pos[cnt] = i;
        out_id[cnt] = m_id;
        if (out_len) out_len[cnt] = m_len;
        ++cnt;
        i += m_len;
        continue;
      }
    }
    ++i;
  }
  return cnt;
}

// Shortest installed special's byte length (bounds the match count of a
// scan: matches never overlap, so <= n / min_len + 1). 0 = no table.
int32_t td_specials_min_len(const void* h) {
  const Tables* t = (const Tables*)h;
  if (!t->sp_ready) return 0;
  int32_t m = 255;
  for (const Tables::SpEntry& e : t->sp_short) m = e.len < m ? e.len : m;
  for (const Tables::SpEntry& e : t->sp_entries) m = e.len < m ? e.len : m;
  return m;
}

// Pretokenize: write piece start byte offsets into `starts` (capacity cap,
// must be >= number of pieces; n+1 always suffices). Returns piece count;
// starts[count] is set to n (end sentinel).
int64_t td_scan(const void* h, const uint8_t* data, int64_t n,
                int32_t* starts, int64_t cap) {
  const Tables* t = (const Tables*)h;
  BScan sc{t, data + n};
  const uint8_t* p = data;
  int64_t count = 0;
  while (p < data + n) {
    if (count >= cap) return -1;
    starts[count++] = (int32_t)(p - data);
    const uint8_t* e = sc.match_end(p);
    p = e > p ? e : p + 1;
  }
  if (count < cap) starts[count] = (int32_t)n;
  return count;
}

// Exact sequential BPE merge of one piece of token ids (in place semantics:
// ids[] holds initial byte ranks, returns merged count).
// Mirrors the reference merge loop semantics
// (src/tiktoken/tiktoken.cpp:282-378) over id pairs.
// Pair-rank lookup during a merge: the rank of the pair (part i, part j)
// is the vocab rank of the byte span covering both parts — the same
// byte-span hashing the reference uses (tiktoken.cpp:282-296). One shared
// table (the whole-piece vocab hash) serves both the fast path and the
// merge, with the 256x256 LUT short-circuiting 2-byte spans.
static inline int32_t span_rank(const Tables* t, const uint8_t* bytes,
                                int64_t s, int64_t e) {
  if (e - s == 2) return t->pair_lut[(size_t)bytes[s] * 256 + bytes[s + 1]];
  int32_t r = vocab_lookup(t, bytes + s, e - s);
  return r >= 0 ? r : MAX_RANK;
}

// Exact heap-based merge for long pieces: O(L log L) instead of the
// rescan loop's O(L^2) (which degenerates on pathological pieces like a
// megabyte-long character run — the reference and tiktoken share that
// quadratic behavior; this path removes it). A lazy-invalidation min-heap
// ordered by (rank, pos) reproduces the sequential leftmost-min order
// exactly: stale entries are detected by comparing against the current
// rank of their position and skipped.
struct HeapItem {
  int32_t rank;
  int32_t pos;
  bool operator<(const HeapItem& o) const {  // max-heap std adapter -> invert
    if (rank != o.rank) return rank > o.rank;
    return pos > o.pos;
  }
};

static int64_t merge_ids_heap(const Tables* t, const uint8_t* bytes,
                              int32_t* ids, int64_t len, Workspace& ws) {
  auto& rank = ws.rank;
  auto& nxt = ws.nxt;
  auto& prv = ws.prv;
  auto& start = ws.start;
  if ((int64_t)rank.size() < len + 1) {
    rank.resize(len + 1);
    nxt.resize(len + 1);
    prv.resize(len + 1);
    start.resize(len + 1);
  }
  std::vector<HeapItem> heap;
  heap.reserve(len);
  for (int64_t i = 0; i < len; ++i) {
    int32_t r = (i + 1 < len)
                    ? t->pair_lut[(size_t)bytes[i] * 256 + bytes[i + 1]]
                    : MAX_RANK;
    rank[i] = r;
    nxt[i] = (int32_t)(i + 1);
    prv[i] = (int32_t)(i - 1);
    start[i] = (int32_t)i;
    if (r != MAX_RANK) heap.push_back({r, (int32_t)i});
  }
  start[len] = (int32_t)len;
  std::make_heap(heap.begin(), heap.end());
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end());
    HeapItem it = heap.back();
    heap.pop_back();
    if (rank[it.pos] != it.rank) continue;  // stale (merged away / refreshed)
    int64_t i = it.pos;
    int64_t j = nxt[i];
    int64_t k = j < len ? nxt[j] : len;
    ids[i] = it.rank;
    nxt[i] = (int32_t)k;
    if (k < len) prv[k] = (int32_t)i;
    rank[j] = MAX_RANK;
    int32_t ri = (k < len) ? span_rank(t, bytes, start[i],
                                       start[nxt[k] <= len ? nxt[k] : len])
                           : MAX_RANK;
    rank[i] = ri;
    if (ri != MAX_RANK) {
      heap.push_back({ri, (int32_t)i});
      std::push_heap(heap.begin(), heap.end());
    }
    int64_t pp = prv[i];
    if (pp >= 0) {
      int32_t rp = span_rank(t, bytes, start[pp], start[k]);
      rank[pp] = rp;
      if (rp != MAX_RANK) {
        heap.push_back({rp, (int32_t)pp});
        std::push_heap(heap.begin(), heap.end());
      }
    }
  }
  int64_t w = 0;
  for (int64_t q = 0; q < len; q = nxt[q]) ids[w++] = ids[q];
  return w;
}

// Above this piece length the heap merge wins over the rescan loop.
constexpr int64_t HEAP_MERGE_MIN = 96;

static int64_t merge_ids(const Tables* t, const uint8_t* bytes, int32_t* ids,
                         int64_t len, Workspace& ws) {
  if (len <= 1) return len;
  if (t->pair_lut.empty()) {
    // no vocab hash installed: fall back to the id-pair table
    return -1;
  }
  if (len == 2) {
    int32_t r = t->pair_lut[(size_t)bytes[0] * 256 + bytes[1]];
    if (r == MAX_RANK) return 2;
    ids[0] = r;
    return 1;
  }
  if (len >= HEAP_MERGE_MIN) return merge_ids_heap(t, bytes, ids, len, ws);
  if ((int64_t)ws.rank.size() < len + 1) {
    ws.rank.resize(len + 1);
    ws.nxt.resize(len + 1);
    ws.prv.resize(len + 1);
    ws.start.resize(len + 1);
  }
  auto& rank = ws.rank;
  auto& nxt = ws.nxt;
  auto& prv = ws.prv;
  auto& start = ws.start;
  // part i spans [start[i], start[nxt[i]]); start[len] = len sentinel.
  // rank[i] = rank of the byte span of parts (i, nxt[i]).
  int64_t min_rank = MAX_RANK;
  int64_t min_idx = -1;
  for (int64_t i = 0; i < len; ++i) {
    int32_t r = (i + 1 < len)
                    ? t->pair_lut[(size_t)bytes[i] * 256 + bytes[i + 1]]
                    : MAX_RANK;
    rank[i] = r;
    if (r < min_rank) {
      min_rank = r;
      min_idx = i;
    }
    nxt[i] = (int32_t)(i + 1);
    prv[i] = (int32_t)(i - 1);
    start[i] = (int32_t)i;
  }
  start[len] = (int32_t)len;
  while (min_rank != MAX_RANK) {
    int64_t i = min_idx;
    int64_t j = nxt[i];                  // right partner
    int64_t k = j < len ? nxt[j] : len;  // part after the pair
    ids[i] = (int32_t)min_rank;          // pair value IS merged token id
    nxt[i] = (int32_t)k;
    if (k < len) prv[k] = (int32_t)i;
    rank[j] = MAX_RANK;
    // refresh: span of (i, k) and of (prv[i], i)
    rank[i] = (k < len)
                  ? span_rank(t, bytes, start[i],
                              start[nxt[k] <= len ? nxt[k] : len])
                  : MAX_RANK;
    int64_t p = prv[i];
    if (p >= 0) rank[p] = span_rank(t, bytes, start[p], start[k]);
    // rescan for global min (leftmost)
    min_rank = MAX_RANK;
    min_idx = -1;
    for (int64_t q = 0; q < len; q = nxt[q]) {
      if (rank[q] < min_rank) {
        min_rank = rank[q];
        min_idx = q;
      }
    }
  }
  // compact alive ids
  int64_t w = 0;
  for (int64_t q = 0; q < len; q = nxt[q]) ids[w++] = ids[q];
  return w;
}

// One piece's ids, resolved in the reference's order: the whole-piece vocab
// hash first (tiktoken.cpp:210-215), then this thread's memo, then the
// exact merge (whose result the memo keeps). `ids` points at them: at
// `one`, the memo's arena or `piece`, valid until the next call on this
// thread. n = -2 where a byte has no rank or no vocab hash is installed
// (the caller falls back to the exact Python path).
struct PieceIds {
  const int32_t* ids;
  int64_t n;
  bool whole;  // a whole-piece hit
};

static inline PieceIds piece_ids(const Tables* t, const uint8_t* p,
                                 int64_t n, std::vector<int32_t>& piece,
                                 Workspace& ws, int32_t* one) {
  uint64_t h = fnv1a(p, n);
  int32_t direct = vocab_lookup_h(t, p, n, h);
  if (direct >= 0) {
    *one = direct;
    return {one, 1, true};
  }
  // memoized merge result for repeated vocab-missing pieces
  if (g_memo.owner != t->gen) g_memo.reset(t->gen);
  if (const MemoEntry* me = g_memo.find(h, p, n))
    return {g_memo.id_arena.data() + me->ids_off, me->n_ids, false};
  if ((int64_t)piece.size() < n) piece.resize(n);
  for (int64_t b = 0; b < n; ++b) {
    int32_t r = t->byte_rank[p[b]];
    if (r < 0) return {nullptr, -2, false};  // vocab lacks a byte's rank
    piece[b] = r;
  }
  int64_t k = merge_ids(t, p, piece.data(), n, ws);
  if (k < 0) return {nullptr, -2, false};  // no vocab hash installed
  g_memo.insert(h, p, n, piece.data(), k);
  return {piece.data(), k, false};
}

// Scan + merge: emit token ids for one ordinary segment. Returns id count,
// or -1 if out capacity is insufficient (cap >= n always suffices) or a
// byte has no rank (caller should use the exact Python fallback).
int64_t td_encode(const void* h, const uint8_t* data, int64_t n, int32_t* out,
                  int64_t cap) {
  const Tables* t = (const Tables*)h;
  BScan sc{t, data + n};
  Workspace ws;
  std::vector<int32_t> piece;
  piece.reserve(1024);
  int32_t one;
  int64_t count = 0;
  const uint8_t* p = data;
  while (p < data + n) {
    const uint8_t* e = sc.match_end(p);
    if (e <= p) e = p + 1;
    PieceIds r = piece_ids(t, p, e - p, piece, ws, &one);
    p = e;
    if (r.n < 0) return r.n;
    if (count + r.n > cap) return -1;
    std::memcpy(out + count, r.ids, r.n * sizeof(int32_t));
    count += r.n;
  }
  return count;
}

// td_splice resolves a window's misses on nthreads threads once it has at
// least SPLICE_PARALLEL_MIN of them. Fewer pay more to wake the team than
// they save: on an H100's 8-core host, forking from 128 misses on cost
// documents of ~300 misses a window a quarter of their throughput, and
// from 1,024 on nothing, while source files of thousands still gained.
constexpr int64_t SPLICE_PARALLEL_MIN = 1024;

// Splice a device window's missed pieces into its ids. ids (n_ids) hold
// `sentinel` at each miss, in piece order; miss j is the piece
// data[ms_s[j], ms_s[j] + ms_l[j]) and resolves as td_encode resolves a
// piece (piece_ids), on up to nthreads threads, each with its own memo.
// out (capacity cap; n_ids - n_ms + the misses' bytes always suffices)
// receives the ids with each sentinel replaced by its piece's ids.
// Returns the id count and sets *n_whole to the misses found whole in the
// vocab and *n_han to those whose first code point has HAN in the
// engine's class table (0 without one); -1 if cap is too small, -2 if a
// byte has no rank or no vocab hash is installed (the caller keeps the
// exact Python splice), -3 if the sentinels are not n_ms, -4 if a miss
// lies outside data.
int64_t td_splice(const void* h, const uint8_t* data, int64_t n,
                  const int64_t* ids, int64_t n_ids, const int32_t* ms_s,
                  const int32_t* ms_l, int64_t n_ms, int64_t sentinel,
                  int64_t* out, int64_t cap, int64_t* n_whole,
                  int64_t* n_han, int nthreads) {
  const Tables* t = (const Tables*)h;
  // miss j's ids land in `got` from off[j], its first byte's offset among
  // the misses' bytes: a piece has no more ids than bytes
  std::vector<int64_t> off(n_ms + 1, 0);
  for (int64_t j = 0; j < n_ms; ++j) {
    if (ms_s[j] < 0 || ms_l[j] < 0 || ms_s[j] + (int64_t)ms_l[j] > n)
      return -4;
    off[j + 1] = off[j] + ms_l[j];
  }
  std::vector<int32_t> got(off[n_ms]);
  std::vector<int64_t> cnt(n_ms);  // miss j's id count, or an error
  // miss j into got and cnt; 1 where it is a whole token
  auto resolve = [&](int64_t j, std::vector<int32_t>& piece,
                     Workspace& ws) -> int64_t {
    int32_t one;
    PieceIds r = piece_ids(t, data + ms_s[j], ms_l[j], piece, ws, &one);
    if (r.n > ms_l[j]) r.n = -1;  // an empty miss that is a token
    cnt[j] = r.n;
    if (r.n > 0)
      std::memcpy(got.data() + off[j], r.ids, r.n * sizeof(int32_t));
    return r.whole;
  };
  int64_t whole = 0;
  if (n_ms >= SPLICE_PARALLEL_MIN && nthreads > 1) {
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads) reduction(+ : whole)
#endif
    {
      Workspace ws;
      std::vector<int32_t> piece;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 32)
#endif
      for (int64_t j = 0; j < n_ms; ++j) whole += resolve(j, piece, ws);
    }
  } else {  // no team at all: a window of few misses runs as td_encode does
    Workspace ws;
    std::vector<int32_t> piece;
    for (int64_t j = 0; j < n_ms; ++j) whole += resolve(j, piece, ws);
  }
  int64_t count = 0, j = 0;
  for (int64_t i = 0; i < n_ids; ++i) {
    if (ids[i] != sentinel) {
      if (count + 1 > cap) return -1;
      out[count++] = ids[i];
      continue;
    }
    if (j == n_ms) return -3;
    int64_t k = cnt[j];
    if (k < 0) return k;
    if (count + k > cap) return -1;
    const int32_t* g = got.data() + off[j];
    for (int64_t q = 0; q < k; ++q) out[count + q] = g[q];
    count += k;
    ++j;
  }
  if (j != n_ms) return -3;
  int64_t han = 0;
  if (t->classes) {
    BScan sc{t, data + n};
    for (int64_t q = 0; q < n_ms; ++q) {
      if (ms_l[q] <= 0) continue;
      int32_t c;
      sc.dec(data + ms_s[q], &c);
      han += (t->classes[c] & HAN) != 0;
    }
  }
  *n_whole = whole;
  *n_han = han;
  return count;
}

// Batch encode: texts[i] = data + offs[i], length offs[i+1]-offs[i]
// (concatenated buffer with n_texts+1 offsets). Token ids for text i are
// written at out + offs[i] (ids never outnumber bytes); counts[i] receives
// the id count. OpenMP-parallel across texts; the whole call runs without
// the GIL (ctypes). Returns 0, or the first nonzero per-text error
// (-2 = vocab lacks single-byte ranks -> caller falls back).
int64_t td_encode_batch(const void* h, const uint8_t* data,
                        const int64_t* offs, int64_t n_texts, int32_t* out,
                        int64_t* counts, int nthreads) {
  int64_t err = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1) num_threads(nthreads)
#endif
  for (int64_t i = 0; i < n_texts; ++i) {
    int64_t n = offs[i + 1] - offs[i];
    int64_t r = td_encode(h, data + offs[i], n, out + offs[i], n);
    counts[i] = r >= 0 ? r : 0;
    if (r < 0) {
#ifdef _OPENMP
#pragma omp critical
#endif
      err = r;
    }
  }
  return err;
}

// Decode: ids -> concatenated token bytes, via the (offsets, lengths,
// blob) tables compiled by tables.py (reference behavior:
// tiktoken.cpp:236-255 decode_bytes — per-id table lookup, concat,
// error on unknown id). Two-call protocol, both GIL-free via ctypes:
//   out == nullptr: validate every id, return the total output byte
//                   count, or -(i+1) for the first bad id at index i.
//   out != nullptr: fill `out` (caller sized it from call one; capacity
//                   passed as `out_cap`) with an OpenMP block-parallel
//                   memcpy pass — each thread re-sums its block's prefix
//                   lengths (memory-speed) so no offset array is
//                   materialized. The fill REVALIDATES every id and
//                   clamps against out_cap: the caller's ids buffer is
//                   read twice across the two calls, so a concurrent
//                   mutation between/during them must never turn into an
//                   out-of-bounds write (output may be garbage then, but
//                   memory safety holds).
int64_t td_decode(const int64_t* ids, int64_t n, const int64_t* offs,
                  const int32_t* lens, const uint8_t* blob,
                  int64_t n_vocab, uint8_t* out, int64_t out_cap,
                  int nthreads) {
  if (out == nullptr) {
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
      int64_t id = ids[i];
      if (id < 0 || id >= n_vocab || lens[id] < 0) return -(i + 1);
      total += lens[id];
    }
    return total;
  }
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  int64_t blk = (n + nthreads - 1) / nthreads;
  if (blk < 1) blk = 1;
  int nblk = (int)((n + blk - 1) / blk);
  // one serial pass computes each block's output offset (the lens table
  // is L2-resident, this runs at memory speed)
  int64_t boff[65];
  int64_t pos = 0;
  for (int b = 0; b < nblk; ++b) {
    boff[b] = pos;
    int64_t hi = (int64_t)(b + 1) * blk < n ? (int64_t)(b + 1) * blk : n;
    for (int64_t i = (int64_t)b * blk; i < hi; ++i) {
      int64_t id = ids[i];
      if (id >= 0 && id < n_vocab && lens[id] > 0) pos += lens[id];
    }
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1) num_threads(nblk)
#endif
  for (int b = 0; b < nblk; ++b) {
    int64_t lo = (int64_t)b * blk;
    int64_t hi = lo + blk < n ? lo + blk : n;
    int64_t p = boff[b];
    for (int64_t i = lo; i < hi; ++i) {
      int64_t id = ids[i];
      if (id < 0 || id >= n_vocab) continue;
      int32_t len = lens[id];
      if (len <= 0 || p + len > out_cap) continue;
      std::memcpy(out + p, blob + offs[id], (size_t)len);
      p += len;
    }
  }
  return pos;
}

}  // extern "C"
