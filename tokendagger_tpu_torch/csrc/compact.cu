// K2+K3: piece keys by stable compaction of the start flags, and
// K4: stable compaction of int32 arrays by a mask.
//
// K2+K3 replace the Pallas kernels compact_tiles (tokendagger_tpu/ops/
// compact_pallas.py:167, call at :288) and degap_keys (:493, call at :561)
// behind compact_piece_keys_butterfly (:849-897). K4 replaces
// compact_by_mask (:750, call at :830).
//
// On the TPU the compaction was a displacement butterfly inside VMEM tiles,
// written at row-quantized offsets and degapped by a second kernel, because
// Mosaic had no usable scatter or in-kernel prefix sum. Here a compaction is
// what it is on any GPU: each tile's count before it comes from a
// decoupled look-back over per-tile status words (lookback.cuh), and the
// output is dense at once, so there is no gap to remove.
//
// What bounds them on the H100: bytes. K2+K3 read the start flags (N/8
// bytes per window packed, N as bytes), each piece's first bytes, and write
// 6 int32 per slot (24 * p_cap bytes, most of the traffic); K4 reads the
// mask and each kept value once and writes every output slot (kept slots
// twice: the fill first). Their work per byte is a few integer operations,
// far below the card's ratio of operations to bytes.
//
// K2+K3 is one launch (piece_keys_kernel, one instance per flag kind) of
// B x T tile blocks of 8192 chars, then B x F fill blocks of 2048 slots.
//  - A tile block reads its flags once: byte flags as two 16-byte loads
//    per thread (32 chars); packed plane-major words by whole warps, each
//    load 32 consecutive words (one 128-byte line) and a ballot of plane
//    j's bit giving 32 chars' flags. A tile is 8192 consecutive chars, so
//    it owns one plane's bit of each word it loads: a tile across all 32
//    planes would need every plane's total, the row's last word, before it
//    could rank a piece (a forward wait on blocks that may not be
//    resident). Each word comes from device memory once and from L2 for
//    the 32 tiles that own its bits.
//  - Warp and block scans rank the tile's starts; their offsets go to
//    shared memory in rank order. The first warp publishes the tile's
//    first start (a tagged word of its own) and count, looks back for the
//    count before it, and publishes its inclusive count (the row's last
//    tile: n_pieces). Meanwhile the second warp finds the first start
//    after the tile (the end of its last piece) from the following tiles'
//    published first starts, or, for a tile not yet published, from its
//    flags (read a second time then, up to its first start): no block
//    waits on a later one. The other warps stage the tile's bytes and the
//    16 after it in shared memory.
//  - Thread k then writes piece k: start, length (the next offset, the
//    look-ahead's start, or nbytes for the row's last piece and for slot
//    p_cap - 1), and four key words from five shared-memory words and
//    funnel shifts, masked to the length and to the row's N bytes.
//    Consecutive threads read consecutive offsets and store to
//    consecutive slots.
//  - Fill block f waits for the inclusive count of its row's last tile
//    and writes its share of the dead slots [min(n_pieces, p_cap), p_cap):
//    start nbytes, length and keys 0. Each slot is written once, by a
//    tile or by a fill block. The fill blocks come after every tile, so
//    none holds a slot while tiles wait to be scheduled.
// Measured by chip_smoke.py (H100 80GB HBM3, 700 W): 0.041 ms at the
// stream's (8, 1,048,576) packed flags with p_cap 349,568 (bound 0.022
// ms), 0.042 and 0.037 ms at the resident byte flags with p_cap 349,568
// and 262,144 (bounds 0.025 and 0.020 ms), 0.023 ms at (1, 4,194,304)
// (bound 0.013 ms), where the three launches it replaced read 0.127,
// 0.067, 0.063 and 0.038 ms. What holds it there (tools/k23_variants.py):
// the piece stores, at about 70% of the memory rate, and each tile's
// look-back wait.
// K4: one pass (mask_compact_kernel): each block ranks its tile and finds
// the count before it by look-back, so every mask byte is read once, in
// 16-byte loads, and every store of a warp lands on consecutive slots.
// Measured by chip_smoke.py (H100 80GB HBM3, 700 W): 0.031 ms at (8,
// 349,568) with k = 2, against a 0.008 ms bound and masked_select's 0.057
// ms; 0.055 ms at (1, 4,194,304), bound 0.020 ms. At these sizes every
// block's chain of latencies (fill, fence, status, look-back, the kept
// loads) outweighs its bytes.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kMaxArrays = 8;

__device__ __forceinline__ uint32_t valid_word(int u, int m) {
  const long long t = (long long)m - 32LL * u;
  if (t >= 32) return 0xFFFFFFFFu;
  if (t <= 0) return 0u;
  return (1u << (uint32_t)t) - 1u;
}

// ---- K2+K3 ----

constexpr int kKeyThreads = 256;
constexpr int kKeyWarps = kKeyThreads / 32;
constexpr int kKeyTile = 32 * kKeyThreads;  // chars per tile block
constexpr int kFillSlots = 2048;            // dead slots per fill block
constexpr int kNone = INT_MAX;              // no start found

// Start flags of the 32 groups u0 .. u0 + 31 of a row (group u: chars
// 32u .. 32u + 31, bit i = char 32u + i), zero at and beyond lim (<= N);
// lane l returns group u0 + l. The whole warp calls it. Packed: the row's
// N/32 plane-major words, bit j of word w = char j * (N/32) + w (N a
// multiple of 1024, so a group lies in one plane); else N flag bytes.
template <bool kPacked>
__device__ __forceinline__ uint32_t group_masks(const uint8_t* frow, int N,
                                                int u0, int lim) {
  const int lane = threadIdx.x & 31;
  if (kPacked) {
    const uint32_t* W = (const uint32_t*)frow;
    const int G = N >> 10;                 // groups per plane
    const int j0 = u0 / G, r0 = u0 - j0 * G;
    uint32_t w[32];
    int j = j0, r = r0;
#pragma unroll
    for (int g = 0; g < 32; ++g) {         // 32 coalesced 128-byte loads
      w[g] = 32 * (u0 + g) < lim ? __ldg(W + 32 * r + lane) : 0u;
      if (++r == G) r = 0;
    }
    uint32_t mine = 0u;
    j = j0;
    r = r0;
#pragma unroll
    for (int g = 0; g < 32; ++g) {
      const uint32_t bal = __ballot_sync(kFull, (w[g] >> (j & 31)) & 1u);
      mine = lane == g ? bal : mine;
      if (++r == G) {
        r = 0;
        ++j;
      }
    }
    return mine & valid_word(u0 + lane, lim);
  }
  const int u = u0 + lane;
  if (32LL * u >= lim) return 0u;
  const uint8_t* p = frow + 32 * u;
  uint32_t m = 0u;
  if (((uintptr_t)p & 15u) == 0u) {
    const uint4 a = __ldg((const uint4*)p), c = __ldg((const uint4*)p + 1);
    m = nonzero4(a.x) | nonzero4(a.y) << 4 | nonzero4(a.z) << 8 |
        nonzero4(a.w) << 12 | nonzero4(c.x) << 16 | nonzero4(c.y) << 20 |
        nonzero4(c.z) << 24 | nonzero4(c.w) << 28;
  } else {
    for (int i = 0; i < 32; ++i) m |= (p[i] != 0 ? 1u : 0u) << i;
  }
  return m & valid_word(u, lim);
}

// The first start below lim in the tiles after tile t, or kNone; by one
// whole warp, without waiting on any block. A tile publishes its first
// start (-1 for none) under the launch's tag in `first`; a tile that has
// not yet done so is read from its flags.
template <bool kPacked>
__device__ int next_start(const uint8_t* frow, int N, int lim, int t, int T,
                          const unsigned long long* first, uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  const uint32_t tag = epoch << 2 | kAgg;
  for (int i = t + 1; (long long)i * kKeyTile < lim;) {
    const int ti = i + lane;
    int f = -3;                  // past the row's live chars: no start
    if (ti < T && (long long)ti * kKeyTile < lim) {
      const unsigned long long s =
          *(volatile const unsigned long long*)(first + ti);
      f = (uint32_t)(s >> 32) == tag ? (int)(uint32_t)s
                                     : -2;   // not yet published
    }
    const uint32_t stop = __ballot_sync(kFull, f != -1);
    if (stop == 0u) {            // 32 published tiles without a start
      i += 32;
      continue;
    }
    const int l = __ffs(stop) - 1;
    const int fl = __shfl_sync(kFull, f, l);
    if (fl >= 0) return fl;
    if (fl == -3) return kNone;
    i += l;                      // tile i is not yet published: its flags
    for (int q = 0; q < kKeyWarps; ++q) {
      const int u0 = i * kKeyThreads + 32 * q;
      const uint32_t m = group_masks<kPacked>(frow, N, u0, lim);
      const uint32_t any = __ballot_sync(kFull, m != 0u);
      if (any) {
        const int a = __ffs(any) - 1;
        return 32 * (u0 + a) + __ffs(__shfl_sync(kFull, m, a)) - 1;
      }
    }
    ++i;
  }
  return kNone;
}

// Mask of the low `n` bytes of a word (n clamped to [0, 4]).
__device__ __forceinline__ uint32_t byte_mask(int n) {
  return n >= 4 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

// Block i (blockIdx.x): tile i % T of row i / T for i < B * T, else fill
// block f = i - B * T, share f % F of row f / F (see the header).
template <bool kPacked>
__global__ void __launch_bounds__(kKeyThreads)
piece_keys_kernel(const uint8_t* flags, const uint8_t* data,
                  const int32_t* nbytes, int B, int N, int T, int F,
                  int p_cap, int32_t* out, long long plane,
                  int32_t* n_pieces, unsigned long long* status,
                  unsigned long long* first, uint32_t epoch) {
  __shared__ uint16_t s_off[kKeyTile];           // starts, in rank order
  __shared__ __align__(16) uint32_t s_data[kKeyTile / 4 + 4];  // + 16 B
  __shared__ int s_warp[kKeyWarps], s_wfirst[kKeyWarps];
  __shared__ int s_base, s_next, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (blockIdx.x >= (unsigned)(B * T)) {
    const int f = blockIdx.x - B * T, b = f / F;
    const unsigned long long* last = status + (size_t)b * T + T - 1;
    if (tid == 0) {
      const uint32_t tag_incl = epoch << 2 | kIncl;
      unsigned long long s;
      while (((s = *(volatile const unsigned long long*)last) >> 32) !=
             tag_incl)
        __nanosleep(256);
      s_total = (int)(uint32_t)s;
    }
    __syncthreads();
    const int lo = (f - b * F) * kFillSlots;
    const int from = max(lo, min(s_total, p_cap));
    const int hi = min(lo + kFillSlots, p_cap);
    if (from < hi) {
      int32_t* o = out + (size_t)b * p_cap;
      fill_range(o, from, hi, nbytes[b]);
      for (int a = 1; a < 6; ++a) fill_range(o + a * plane, from, hi, 0);
    }
    return;
  }

  const int b = blockIdx.x / T, t = blockIdx.x - b * T;
  const int nb = nbytes[b];
  const int lim = min(nb, N);   // chars that may start a live piece
  const int t0 = t * kKeyTile;
  unsigned long long* st = status + (size_t)b * T;
  const uint8_t* frow = flags + (size_t)b * (kPacked ? N / 8 : N);
  const int u0 = t * kKeyThreads + 32 * warp;  // the warp's first group
  const uint32_t m = group_masks<kPacked>(frow, N, u0, lim);
  const int c = __popc(m);
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  const uint32_t any = __ballot_sync(kFull, c != 0);
  const int a = any ? __ffs(any) - 1 : 0;
  const uint32_t ma = __shfl_sync(kFull, m, a);
  if (lane == 31) {
    s_warp[warp] = x;
    s_wfirst[warp] = any ? 32 * (u0 + a) + __ffs(ma) - 1 : -1;
  }
  __syncthreads();
  int before = 0, total = 0, first_start = -1;
#pragma unroll
  for (int w = 0; w < kKeyWarps; ++w) {
    const int v = s_warp[w];
    before += w < warp ? v : 0;
    if (first_start < 0 && v) first_start = s_wfirst[w];
    total += v;
  }

  if (warp == 0) {
    if (lane == 0)
      put_status(first + (size_t)b * T + t, epoch << 2 | kAgg,
                 total ? first_start : -1);
    const int base = look_back(st, t, total, epoch);
    if (lane == 0) {
      s_base = base;
      if (t == T - 1) n_pieces[b] = base + total;
    }
  } else if (warp == 1) {
    const int nxt = total ? next_start<kPacked>(
                                frow, N, lim, t, T, first + (size_t)b * T,
                                epoch)
                          : kNone;
    if (lane == 0) s_next = nxt;
  } else if (total) {           // the tile's bytes and the 16 after it
    const uint8_t* drow = data + (size_t)b * N;
    const bool aligned = ((uintptr_t)drow & 15u) == 0u;
    for (int q = tid - 64; q <= kKeyTile / 16; q += kKeyThreads - 64) {
      const int at = t0 + 16 * q;   // N % 32 == 0: a chunk is in or out
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (at < N && aligned) {
        v = __ldg((const uint4*)(drow + at));
      } else if (at < N) {
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
        for (int i = 0; i < 16; ++i)
          wd[i >> 2] |= (uint32_t)drow[at + i] << (8 * (i & 3));
        v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
      *(uint4*)(s_data + 4 * q) = v;
    }
  }
  // the offsets of this thread's starts, in rank order
  for (uint32_t mm = m, p = before + x - c; mm; mm &= mm - 1u)
    s_off[p++] = (uint16_t)(32 * tid + __ffs(mm) - 1);
  __syncthreads();
  if (total == 0) return;

  // piece k of the tile goes to slot base + k below p_cap: consecutive
  // threads read consecutive offsets (no bank conflicts) and store to
  // consecutive slots
  const int base = s_base, nxt = s_next;
  const int keep = max(0, min(total, p_cap - base));
  int32_t* orow = out + (size_t)b * p_cap + base;
  for (int k = tid; k < keep; k += kKeyThreads) {
    const int o = s_off[k];
    const int s = t0 + o;
    const int e = base + k + 1 >= p_cap ? nb
                  : k + 1 < total       ? t0 + s_off[k + 1]
                  : nxt == kNone        ? nb
                                        : nxt;
    const int len = e - s;
    const int nk = min(min(len, 16), N - s);
    const int wi = o >> 2;
    const uint32_t sh = 8u * (uint32_t)(o & 3);
    uint32_t w[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) w[q] = s_data[wi + q];
    int32_t* d = orow + k;
    d[0] = s;
    d[plane] = len;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      d[(2 + q) * plane] = (int32_t)(__funnelshift_r(w[q], w[q + 1], sh) &
                                     byte_mask(nk - 4 * q));
  }
}

// ---- K4 ----

constexpr int kMaskThreads = 256;
constexpr int kMaskVec = 16;                        // mask bytes per thread
constexpr int kMaskTile = kMaskThreads * kMaskVec;  // elements per block

struct Ins {
  const int32_t* p[kMaxArrays];
};

// One block per tile of kMaskTile elements of a row, tiles of a row in
// block order (a block waits only on blocks launched before it):
//  1. fill every output slot of the tile's own range; the fence and the
//     status store below publish these stores before any block can learn
//     where its kept elements go, so kept values (which always move left,
//     into this tile's range or an earlier one) overwrite them afterwards;
//  2. each thread reads 16 consecutive mask bytes (one 16-byte load where
//     the row allows it) and counts them; a warp scan and a block scan
//     rank the threads, and the tile's count is published (aggregate);
//  3. the first warp looks back over the statuses of the tiles before it,
//     32 at a time, summing aggregates up to the nearest inclusive count,
//     and publishes its own inclusive count (decoupled look-back);
//  4. each warp walks its 512 elements 32 at a time, lane l on element
//     32j + l: a ballot of the keep bits, and each kept element goes to
//     base + popc(ballot & lanes below), so consecutive lanes read
//     consecutive inputs and write consecutive slots.
__global__ void __launch_bounds__(kMaskThreads)
mask_compact_kernel(const uint8_t* mask, int P, int T, Ins in, int k,
                    int32_t fill, int32_t* out, long long plane,
                    unsigned long long* status, uint32_t epoch) {
  __shared__ int s_warp[kMaskThreads / 32];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = kMaskThreads / 32;
  const int b = blockIdx.x / T, t = blockIdx.x - b * T;
  const size_t row = (size_t)b * P;
  const int t0 = t * kMaskTile;
  const int tn = min(kMaskTile, P - t0);

#pragma unroll
  for (int a = 0; a < kMaxArrays; ++a) {
    if (a < k) {
      int32_t* o = out + a * plane + row + t0;
      for (int i = tid; i < tn; i += kMaskThreads) o[i] = fill;
    }
  }

  const int e0 = t0 + kMaskVec * tid;
  const uint8_t* mrow = mask + row;
  uint32_t bits = 0u;
  if (e0 + kMaskVec <= P && ((uintptr_t)(mrow + e0) & 15u) == 0u) {
    const uint4 v = *(const uint4*)(mrow + e0);
    bits = nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 |
           nonzero4(v.w) << 12;
  } else {
    for (int j = 0; j < kMaskVec && e0 + j < P; ++j)
      bits |= (mrow[e0 + j] != 0 ? 1u : 0u) << j;
  }
  const int c = __popc(bits);
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __threadfence();
  __syncthreads();

  if (warp == 0) {
    int wv = lane < nw ? s_warp[lane] : 0;
    int ws = wv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, ws, d);
      if (lane >= d) ws += y;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, ws, nw - 1);
    if (lane < nw) s_warp[lane] = ws - wv;
    const int excl = look_back(status + (size_t)b * T, t, total, epoch);
    if (lane == 0) s_base = excl;
    __threadfence();
  }
  __syncthreads();

  int pos = s_base + s_warp[warp];  // the warp's first slot
  const int ew = t0 + warp * 32 * kMaskVec;
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll 4
  for (int j = 0; j < kMaskVec; ++j) {
    const uint32_t m16 =
        __shfl_sync(0xFFFFFFFFu, bits, 2 * j + (lane >> 4));
    const bool keep = (m16 >> (lane & 15)) & 1u;
    const uint32_t bal = __ballot_sync(0xFFFFFFFFu, keep);
    if (keep) {
      const size_t dst = row + pos + __popc(bal & below);
      const size_t src = row + ew + 32 * j + lane;
#pragma unroll
      for (int a = 0; a < kMaxArrays; ++a)
        if (a < k) out[a * plane + dst] = in.p[a][src];
    }
    pos += __popc(bal);
  }
}

}  // namespace


extern "C" {

// Status words (64-bit) td_compact_piece_keys needs for B windows of N
// chars: a status and a first start per tile.
long long td_piece_keys_status_words(int B, int N) {
  return 2LL * B * ((N + kKeyTile - 1) / kKeyTile);
}

// flags: (B, N) uint8 (packed = 0; N % 32 == 0) or (B, N/32) uint32
// plane-major words (packed = 1; N % 1024 == 0); data (B, N) uint8; nbytes
// (B,) int32; out (6, B, p_cap) int32: start_b, piece_len, k0..k3;
// n_pieces (B,) int32. status: at least td_piece_keys_status_words(B, N)
// words that only this kernel writes (the statuses first, then the first
// starts), zeroed before their first use; epoch as for td_compact_by_mask.
// One launch.
int td_compact_piece_keys(const void* flags, int packed, const void* data,
                          const void* nbytes, int B, int N, int p_cap,
                          void* out, void* n_pieces, void* status,
                          unsigned epoch, void* stream) {
  const long long T = (N + kKeyTile - 1) / kKeyTile;
  const long long F = ((long long)p_cap + kFillSlots - 1) / kFillSlots;
  const long long blocks = (long long)B * (T + F);
  if (B < 1 || N < 32 || N % 32 || (packed && N % 1024) || p_cap < 1 ||
      blocks > INT_MAX || epoch == 0u || epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  unsigned long long* st = (unsigned long long*)status;
  auto kernel = packed ? piece_keys_kernel<true> : piece_keys_kernel<false>;
  kernel<<<(unsigned)blocks, kKeyThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flags, (const uint8_t*)data, (const int32_t*)nbytes,
      B, N, (int)T, (int)F, p_cap, (int32_t*)out, (long long)B * p_cap,
      (int32_t*)n_pieces, st, st + B * T, epoch);
  return (int)cudaGetLastError();
}

// Status words (64-bit) td_compact_by_mask needs for a (B, P) mask.
long long td_compact_status_words(int B, int P) {
  return (long long)B * ((P + kMaskTile - 1) / kMaskTile);
}

// mask (B, P) uint8 (nonzero: keep); in0..in7 the k (B, P) int32 inputs
// (k <= 8, the rest unused); out (k, B, P) int32. status: at least
// td_compact_status_words(B, P) words that only this kernel writes, zeroed
// before their first use; epoch in [1, 2^30), unlike the epoch of the
// launch before on the same words (a status of another epoch reads as not
// yet published, so nothing is cleared between launches). Launches that
// share `status` must not overlap: give each stream its own. One launch.
int td_compact_by_mask(const void* mask, int B, int P, const void* in0,
                       const void* in1, const void* in2, const void* in3,
                       const void* in4, const void* in5, const void* in6,
                       const void* in7, int k, int fill, void* out,
                       void* status, unsigned epoch, void* stream) {
  if (k < 1 || k > kMaxArrays || epoch == 0u || epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  const Ins in{{(const int32_t*)in0, (const int32_t*)in1,
                (const int32_t*)in2, (const int32_t*)in3,
                (const int32_t*)in4, (const int32_t*)in5,
                (const int32_t*)in6, (const int32_t*)in7}};
  const int T = (P + kMaskTile - 1) / kMaskTile;
  mask_compact_kernel<<<(unsigned)((long long)B * T), kMaskThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)mask, P, T, in, k, fill, (int32_t*)out,
      (long long)B * P, (unsigned long long*)status, epoch);
  return (int)cudaGetLastError();
}

}  // extern "C"
