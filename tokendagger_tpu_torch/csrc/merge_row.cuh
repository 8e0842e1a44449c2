// One row of the device BPE merge, written once for the card and the host.
//
// The state of a row of width C (1..256) is four arrays of C entries, each
// entry `stride` elements from the next (the card interleaves the rows a
// block holds, so that the threads of a warp reading the same column hit
// different banks; the host keeps them contiguous):
//   tok[c]  the id of the part that starts at column c, -1 at a dead slot;
//   pr[c]   the rank of the pair (part at c, next part), kMaxRank if none;
//   nxt[c]  the column of the next part, kNoNext if none (a real next is
//           > c >= 0, so 0 is free);
//   prv[c]  the column of the previous part, kNoPrev if none (a real
//           previous part is < c <= 255, so 255 is free).
// So the links fit in one byte each at any C <= 256, and a row costs 10 B a
// column.
//
// merge.cu runs a row on G lanes with these routines: init_row, each
// lane's lane_min, then repeatedly the row's leftmost minimum (warp
// shuffles or reductions over the lanes' minima, ordered by before),
// read_step, the two lookups, splice, and lane_min again on the lanes the
// step touched. merge_host.cpp runs the same routines for G lanes one
// after another on the host, so that the CPU tests hold them against the
// plain loop of ops/merge.py without a card; the shuffles and reductions
// themselves are checked on the card (chip_smoke.py).
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifndef TD_FN
#ifdef __CUDACC__
#define TD_FN __host__ __device__ __forceinline__
#define TD_UNROLL _Pragma("unroll")
#else
#define TD_FN inline
#define TD_UNROLL
#endif
#endif

namespace td_merge {

constexpr int kMaxRank = 0x7FFFFFFF;
constexpr int kNoNext = 0;
constexpr int kNoPrev = 255;

struct alignas(16) Q4 {
  int x, y, z, w;
};

// 16 bytes of the pair table; on the card through the read-only cache.
TD_FN Q4 load_q4(const int* p) {
#ifdef __CUDA_ARCH__
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  return Q4{v.x, v.y, v.z, v.w};
#else
  return Q4{p[0], p[1], p[2], p[3]};
#endif
}

TD_FN int load_i(const int* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

TD_FN int load_u8(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// tables._mix_hash: a uint32 multiply-xor mix of the two ids.
TD_FN unsigned mix(int a, int b, unsigned c1, unsigned c2, unsigned c3,
                   unsigned mask) {
  unsigned h = (unsigned)a * c1 + (unsigned)b * c2;
  h ^= h >> 16;
  h *= c3;
  h ^= h >> 15;
  return h & mask;
}

// The slots of a row (a key quad ka, kb) that hold (a, b): bit j for
// slot j.
TD_FN unsigned match(Q4 ka, Q4 kb, int a, int b) {
  return (unsigned)(ka.x == a && kb.x == b) |
         (unsigned)(ka.y == a && kb.y == b) << 1 |
         (unsigned)(ka.z == a && kb.z == b) << 2 |
         (unsigned)(ka.w == a && kb.w == b) << 3;
}

// The largest value of the slots in hit (a nonempty bit set).
TD_FN int pick(Q4 v, unsigned hit) {
  int r = -1;
  if (hit & 1) r = v.x;
  if ((hit & 2) && v.y > r) r = v.y;
  if ((hit & 4) && v.z > r) r = v.z;
  if ((hit & 8) && v.w > r) r = v.w;
  return r;
}

// The key quads of the two candidate rows of (a, b) in the (mask + 1, 12)
// pair table. A row is [ka x4][kb x4][value x4]; the values are loaded
// only for a row that holds the key (resolve), so a miss costs four 16-byte
// loads and a hit five, where loading both rows whole costs six. A
// negative id (a dead slot, no part) always misses and loads nothing.
struct Probe {
  const int* r0;
  const int* r1;
  Q4 a0, b0, a1, b1;
};

TD_FN Probe probe(const int* rows, unsigned mask, int a, int b) {
  const unsigned h0 = mix(a, b, 0x9E3779B1u, 0x85EBCA77u, 0x7FEB352Du, mask);
  const unsigned h1 = mix(a, b, 0xC2B2AE3Du, 0x27D4EB2Fu, 0x165667B1u, mask);
  Probe q;
  q.r0 = rows + (size_t)h0 * 12;
  q.r1 = rows + (size_t)h1 * 12;
  if (a >= 0 && b >= 0) {
    q.a0 = load_q4(q.r0);
    q.b0 = load_q4(q.r0 + 4);
    q.a1 = load_q4(q.r1);
    q.b1 = load_q4(q.r1 + 4);
  } else {
    q.a0 = q.b0 = q.a1 = q.b1 = Q4{0, 0, 0, 0};
  }
  return q;
}

// rank(bytes(a) + bytes(b)) from a probe: the first row's value if it
// holds the key, else the second's, kMaxRank if neither does.
TD_FN int resolve(const Probe& q, int a, int b) {
  if (a < 0 || b < 0) return kMaxRank;
  const unsigned m0 = match(q.a0, q.b0, a, b);
  const unsigned m1 = match(q.a1, q.b1, a, b);
  const int first = m0 ? pick(load_q4(q.r0 + 8), m0) : -1;
  if (first >= 0) return first;
  const int second = m1 ? pick(load_q4(q.r1 + 8), m1) : -1;
  return second >= 0 ? second : kMaxRank;
}

TD_FN int lookup(const int* rows, unsigned mask, int a, int b) {
  return resolve(probe(rows, mask, a, b), a, b);
}

// A row's state; entry c of each array is c * stride elements in.
template <int S>
struct Row {
  int* tok;
  int* pr;
  uint8_t* nxt;
  uint8_t* prv;
  TD_FN int& t(int c) const { return tok[c * S]; }
  TD_FN int& p(int c) const { return pr[c * S]; }
  TD_FN int next(int c) const {  // -1 if none
    const int n = nxt[c * S];
    return n == kNoNext ? -1 : n;
  }
  TD_FN int prev(int c) const {  // -1 if none
    const int q = prv[c * S];
    return q == kNoPrev ? -1 : q;
  }
  TD_FN void set_next(int c, int n) const {
    nxt[c * S] = (uint8_t)(n < 0 ? kNoNext : n);
  }
};

// Columns c0, c0 + dc, ... (< C) of a row of length L (0 <= L <= C) whose
// bytes are src: the byte ids, the links, and the first-round rank of
// each pair (c, c + 1) (from lut when given, else the pair table). In
// three passes, each pass's loads independent of one another, so that a
// thread has a pass's loads in flight at once (one round trip a pass, not
// three dependent ones a column): the bytes (parked in prv), their ids
// with the lut's ranks, then the table's ranks. sync() runs between
// passes: a pass reads column c + 1, which may be another thread's.
template <int S, class Sync>
TD_FN void init_row(const Row<S>& row, const uint8_t* src, int L, int C,
                    int c0, int dc, const int* byte_rank, const int* rows,
                    unsigned mask, const int* lut, Sync sync) {
  for (int c = c0; c < L; c += dc) row.prv[c * S] = (uint8_t)load_u8(src + c);
  sync();
  for (int c = c0; c < C; c += dc) {
    const int x = row.prv[c * S];
    row.t(c) = c < L ? load_i(byte_rank + x) : -1;
    row.p(c) = lut != nullptr && c < L - 1
                   ? load_i(lut + x * 256 + row.prv[(c + 1) * S])
                   : kMaxRank;
    row.nxt[c * S] = (uint8_t)(c < L - 1 ? c + 1 : kNoNext);
  }
  sync();
  for (int c = c0; c < C; c += dc)
    row.prv[c * S] = (uint8_t)(c > 0 && c < L ? c - 1 : kNoPrev);
  if (lut == nullptr) {
    // the pairs' ranks, two lookups in flight a thread
    for (int c = c0; c < L - 1; c += 2 * dc) {
      const int d = c + dc;
      const bool two = d < L - 1;
      const int a0 = row.t(c), b0 = row.t(c + 1);
      const int a1 = two ? row.t(d) : -1, b1 = two ? row.t(d + 1) : -1;
      const Probe q0 = probe(rows, mask, a0, b0);
      const Probe q1 = probe(rows, mask, a1, b1);
      row.p(c) = resolve(q0, a0, b0);
      if (two) row.p(d) = resolve(q1, a1, b1);
    }
  }
  sync();
}

// The leftmost minimum (rank, column) of the columns j, j + G, ... (< C)
// that lane j of a row's G lanes owns, at most K of them; (kMaxRank, C)
// if none has a pair. The loads go out together, then the compares.
template <int K, int S>
TD_FN void lane_min(const Row<S>& row, int j, int G, int C, int& rank,
                    int& col) {
  int x[K];
  TD_UNROLL
  for (int k = 0; k < K; ++k) {
    const int c = j + k * G;
    x[k] = c < C ? row.p(c) : kMaxRank;
  }
  rank = kMaxRank;
  col = C;
  TD_UNROLL
  for (int k = 0; k < K; ++k)
    if (x[k] < rank) {
      rank = x[k];
      col = j + k * G;
    }
}

// Whether (r1, c1) comes before (r0, c0): the smaller rank, then the
// smaller column. The row's leftmost minimum is the first of its lanes'.
TD_FN bool before(int r1, int c1, int r0, int c0) {
  return r1 < r0 || (r1 == r0 && c1 < c0);
}

// One merge of the pair at column b (its rank v is the merged id): the
// right part b2, the part after it b3 and the part before b, p (-1 if
// none), with the ids the two new pairs need.
struct Step {
  int b, v, b2, b3, p, t3, tp;
};

template <int S>
TD_FN Step read_step(const Row<S>& row, int b, int v) {
  Step s;
  s.b = b;
  s.v = v;
  s.b2 = row.next(b);  // a pair at b has a right part
  s.b3 = row.next(s.b2);
  s.p = row.prev(b);
  s.t3 = s.b3 >= 0 ? row.t(s.b3) : -1;
  s.tp = s.p >= 0 ? row.t(s.p) : -1;
  return s;
}

// The merge's writes but pr[p]: part b takes id v and the pair (b, b3)
// with rank right; b2 dies.
template <int S>
TD_FN void splice(const Row<S>& row, const Step& s, int right) {
  row.t(s.b) = s.v;
  row.t(s.b2) = -1;
  row.p(s.b2) = kMaxRank;
  row.set_next(s.b, s.b3);
  if (s.b3 >= 0) row.prv[s.b3 * S] = (uint8_t)s.b;
  row.p(s.b) = right;
}

// Whether lane j of G owns a column the merge s changed (b, b2, p), so
// that it must take its minimum again.
TD_FN bool touched(const Step& s, int j, int G) {
  return s.b % G == j || s.b2 % G == j || (s.p >= 0 && s.p % G == j);
}

}  // namespace td_merge
