// One piece of the whole-piece probe, written once for the card and the
// host.
//
// A piece is its four key words k0..k3 (its first 16 bytes, little-endian,
// zero padded) and its byte length. Its bucket is a row of the
// (mask + 1, 48) int32 vhash8 table (tables._build_vocab_hash8), slot-major:
//   [k0 x8][k1 x8][k2 x8][k3 x8][len x8][rank x8]
// so each group of eight is one 32-byte sector. An empty slot has len -1,
// keys 0 and rank 0. The answer is the largest rank among the slots whose
// four words and length equal the piece's, -1 if none does.
//
// probe.cu runs probe_piece on one thread a piece; probe_host.cpp runs it
// on the host, so that the CPU tests hold it against the plain version of
// ops/join.py and the JAX package without a card.
#pragma once
#include "merge_row.cuh"

namespace td_probe {

constexpr int kRowInts = 48;
constexpr int kLenAt = 32;   // the len group's offset in a row
constexpr int kRankAt = 40;  // the rank group's

struct Query {
  int k0, k1, k2, k3, len;
};

// The bucket: tables._vhash_ab folded by tables._mix_hash(which = 0), in
// uint32 arithmetic (ops/join.vhash_ab and merge._mix in torch).
TD_FN unsigned bucket(const Query& q, unsigned mask) {
  const unsigned a = (unsigned)q.k0 * 0x85EBCA77u + (unsigned)q.k2 * 31u +
                     (unsigned)q.len * 131u;
  const unsigned b = (unsigned)q.k1 * 0xC2B2AE3Du + (unsigned)q.k3 * 31u;
  return td_merge::mix((int)a, (int)b, 0x9E3779B1u, 0x85EBCA77u, 0x7FEB352Du,
                       mask);
}

TD_FN const int* bucket_row(const int* rows, unsigned mask, const Query& q) {
  return rows + (size_t)bucket(q, mask) * kRowInts;
}

// Slot s's rank once its length is known to equal q's: its four key words,
// then its rank only if they all match; -1 otherwise.
TD_FN int keys_rank(const int* row, int s, const Query& q) {
  const int k0 = td_merge::load_i(row + s);
  const int k1 = td_merge::load_i(row + 8 + s);
  const int k2 = td_merge::load_i(row + 16 + s);
  const int k3 = td_merge::load_i(row + 24 + s);
  if (k0 != q.k0 || k1 != q.k1 || k2 != q.k2 || k3 != q.k3) return -1;
  return td_merge::load_i(row + kRankAt + s);
}

// The slots whose length equals len, bit s for slot s: the len sector in
// two 16-byte loads.
TD_FN unsigned len_hits(const int* row, int len) {
  const td_merge::Q4 lo = td_merge::load_q4(row + kLenAt);
  const td_merge::Q4 hi = td_merge::load_q4(row + kLenAt + 4);
  return (unsigned)(lo.x == len) | (unsigned)(lo.y == len) << 1 |
         (unsigned)(lo.z == len) << 2 | (unsigned)(lo.w == len) << 3 |
         (unsigned)(hi.x == len) << 4 | (unsigned)(hi.y == len) << 5 |
         (unsigned)(hi.z == len) << 6 | (unsigned)(hi.w == len) << 7;
}

TD_FN int lowest_bit(unsigned m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// The whole probe of one piece by one thread: the len sector, then the key
// words and rank of each slot of q's length.
TD_FN int probe_piece(const int* rows, unsigned mask, const Query& q) {
  const int* row = bucket_row(rows, mask, q);
  int r = -1;
  for (unsigned m = len_hits(row, q.len); m; m &= m - 1) {
    const int v = keys_rank(row, lowest_bit(m), q);
    r = v > r ? v : r;
  }
  return r;
}

}  // namespace td_probe
