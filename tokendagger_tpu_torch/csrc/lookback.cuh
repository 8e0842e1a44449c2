// Pieces shared by the one-pass compactions (compact.cu: K2+K3, K4;
// route.cu: K5+K6): tile statuses tagged with a per-launch epoch, the
// decoupled look-back over them, and a block-wide fill.
//
// A launch's statuses are 64-bit words, one per tile: the tag (epoch << 2
// | kAgg or kIncl) above, a count below. The words are zeroed once, when
// allocated, and never cleared: a word whose tag holds another epoch reads
// as not yet published, so each launch needs an epoch unlike the one
// before on the same words. Tiles of a row are blocks in launch order, and
// a block waits only on blocks launched before it.
#pragma once

#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kAgg = 1u, kIncl = 2u;  // tile status flags

// Bit i set where byte i of x is nonzero (i < 4).
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return (((x & 0x01010101u) * 0x01020408u) >> 24) & 0xFu;
}

// A tile's status: tag (epoch << 2 | flag) above, its count below.
__device__ __forceinline__ void put_status(unsigned long long* s,
                                           uint32_t tag, int v) {
  *(volatile unsigned long long*)s =
      (unsigned long long)tag << 32 | (uint32_t)v;
}

// Decoupled look-back by one whole warp for tile t of a row whose tile
// statuses are st[0 .. t]: publishes the tile's count `total` (aggregate),
// sums the counts of the tiles before it, 32 at a time, back to the
// nearest inclusive count, and publishes its own inclusive count. Returns
// the count before the tile. Waits only on tiles before t.
__device__ int look_back(unsigned long long* st, int t, int total,
                         uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  const uint32_t tag_agg = epoch << 2 | kAgg, tag_incl = epoch << 2 | kIncl;
  int excl = 0;
  if (t > 0) {
    if (lane == 0) put_status(st + t, tag_agg, total);
    for (int pred = t - 1;; pred -= 32) {
      const int i = pred - lane;
      unsigned long long s = 0ull;
      uint32_t tag = tag_incl;
      if (i >= 0) {
        do {
          s = *(volatile unsigned long long*)(st + i);
          tag = (uint32_t)(s >> 32);
        } while (tag != tag_agg && tag != tag_incl);
      }
      const uint32_t incl = __ballot_sync(kFull, tag == tag_incl);
      const int first = incl ? __ffs(incl) - 1 : 31;
      int v = lane <= first && i >= 0 ? (int)(uint32_t)s : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
      excl += v;
      if (incl) break;
    }
  }
  if (lane == 0) put_status(st + t, tag_incl, excl + total);
  return excl;
}

// o[lo, hi) = v by the whole block, in 16-byte stores where aligned.
__device__ void fill_range(int32_t* o, int lo, int hi, int32_t v) {
  const int mis = (int)(((uintptr_t)(o + lo) >> 2) & 3u);
  const int head = min(hi, lo + ((4 - mis) & 3));
  for (int i = lo + threadIdx.x; i < head; i += blockDim.x) o[i] = v;
  const int nq = (hi - head) >> 2;
  int4* q = (int4*)(o + head);
  const int4 vv = make_int4(v, v, v, v);
  for (int i = threadIdx.x; i < nq; i += blockDim.x) q[i] = vv;
  for (int i = head + 4 * nq + threadIdx.x; i < hi; i += blockDim.x)
    o[i] = v;
}

}  // namespace
