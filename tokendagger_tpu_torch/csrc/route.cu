// K5+K6: stable compaction by a mask that records its route, and
// K7+K8: expansion of a dense prefix back along that route.
//
// K5+K6 replace the Pallas kernels compact_tiles_masked (tokendagger_tpu/
// ops/compact_pallas.py:355, call at :434) and degap_record (:579, call at
// :624); K7+K8 replace regap_replay (:643, call at :670) and
// expand_tiles_replay (:684, call at :728). The JAX package composes them as
// "compact a mask's elements to a dense prefix, work on the prefix, put the
// results back where the elements came from" (pretokenize.utf8_decode_tiles
// and expand_starts_replay, bitplane.class_lookup_hot, join.vocab_probe_hot).
//
// On the TPU each (256, 128) tile was compacted by a butterfly and written at
// a row-quantized offset, a second butterfly removed the gaps, and both
// recorded their take masks so that two inverse replays could route values
// back: Mosaic had no scatter and no in-kernel prefix sum. Here the route is
// what the compaction's scan yields anyway: for each element its rank among
// the kept elements of its row, -1 off the mask. The expansion is one gather
// pass, out[j] = dense[route[j]], with nothing to clear first.
//
// What bounds them on the H100: bytes. K5+K6 read the mask (1 byte per
// element) and the kept values, and write every dense slot and the route
// (4 bytes per element); K7+K8 read the route, the mask and the values they
// fetch, and write 4 bytes per element. Each does a few integer operations
// per byte, far below the card's ratio of operations to bytes.
//
// K5+K6 is one pass (record_kernel), in the shape of K4 (compact.cu): one
// block per tile of 4096 elements, each mask byte read once in 16-byte
// loads, the count before a tile found by decoupled look-back over per-tile
// status words, and every route store of a warp on 32 consecutive slots.
// Unlike K4 it writes no dense slot twice: kept values go to [0, total) and
// the row's last tile, the first to know the row's total, fills
// [total, cap) itself, so the two never meet and no fence orders them. On
// the main path a row's fill is a few hundred to 22 K slots; a row with
// few kept elements and a large cap leaves that one block a long fill.
// What holds it above its bound on the main path (tools/k5_variants.py):
// the kept values and the route. At 11% (the hot-codepoint classes) or
// 35% (the hot-piece probe) of a row kept, a warp's loads of its kept
// values still fetch nearly every 32-byte sector of the inputs, so they
// are read whole where the bound counts the kept values only; the route
// is 4 bytes per element whatever the mask.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;                      // mask bytes per thread
constexpr int kTile = kThreads * kVec;        // elements per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxArrays = 8;

struct Ins {
  const int32_t* p[kMaxArrays];
};

// Whether lane l's element 32j + l of its warp's 512 is kept; `bits` holds
// each thread's 16 keep bits (thread q: elements 16q .. 16q + 15).
__device__ __forceinline__ bool kept(uint32_t bits, int j, int lane) {
  return (__shfl_sync(kFull, bits, 2 * j + (lane >> 4)) >> (lane & 15)) & 1u;
}

// v[j] = src[32 j] for the lane's kept elements: 16 loads in flight.
__device__ __forceinline__ void load_kept(int32_t (&v)[kVec],
                                          const int32_t* src, uint32_t bits,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    v[j] = kept(bits, j, lane) ? __ldg(src + 32 * j) : 0;
}

// Ranks the warp's elements from `first` on; each kept element below cap
// stores its v[j] to dense[rank]. With `route` (the warp's first element,
// n of them in the row) it also writes each element's rank or -1.
__device__ __forceinline__ void store_kept(const int32_t (&v)[kVec],
                                           int32_t* dense, int first,
                                           uint32_t bits, int lane, int cap,
                                           int32_t* route, int n) {
  const uint32_t below = (1u << lane) - 1u;
  int pos = first;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const bool keep = kept(bits, j, lane);
    const uint32_t bal = __ballot_sync(kFull, keep);
    const int rank = pos + __popc(bal & below);
    if (route != nullptr && 32 * j + lane < n)
      route[32 * j + lane] = keep ? rank : -1;
    if (keep && rank < cap) dense[rank] = v[j];
    pos += __popc(bal);
  }
}

// One block per tile of kTile elements of a row, tiles of a row in block
// order (a block waits only on blocks launched before it):
//  1. each thread reads 16 consecutive mask bytes (one 16-byte load where
//     the row allows it) and counts them; a warp scan and a block scan
//     rank the threads, and the tile's count is published (aggregate);
//  2. the first warp looks back over the statuses of the tiles before it,
//     32 at a time, summing aggregates up to the nearest inclusive count,
//     and publishes its own inclusive count; the row's last tile writes it
//     to totals;
//  3. each warp walks its 512 elements 32 at a time, lane l on element
//     32j + l: a ballot of the keep bits gives each element its rank, and
//     the route gets the rank or -1 (one coalesced store per warp); each
//     lane loads the values of its kept elements (16 loads in flight;
//     array 0's already while the first warp looks back) and stores those
//     below cap to dense[a][rank];
//  4. the row's last tile fills the dense slots [total, cap).
// Six blocks per SM (40 registers) measured faster than four (48) at all
// three resident shapes (tools/k5_variants.py).
__global__ void __launch_bounds__(kThreads, 6)
record_kernel(const uint8_t* mask, int N, int T, Ins in, int k, int cap,
              int32_t fill, int32_t* out, long long plane, int32_t* route,
              int32_t* totals, unsigned long long* status, uint32_t epoch) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_base, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / T, t = blockIdx.x - b * T;
  const size_t row = (size_t)b * N, orow = (size_t)b * cap;
  const int t0 = t * kTile;

  const int e0 = t0 + kVec * tid;
  const uint8_t* mrow = mask + row;
  uint32_t bits = 0u;
  if (e0 + kVec <= N && ((uintptr_t)(mrow + e0) & 15u) == 0u) {
    const uint4 v = *(const uint4*)(mrow + e0);
    bits = nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 |
           nonzero4(v.w) << 12;
  } else {
    for (int j = 0; j < kVec && e0 + j < N; ++j)
      bits |= (mrow[e0 + j] != 0 ? 1u : 0u) << j;
  }
  int x = __popc(bits);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();

  // array 0's kept values, loaded while the first warp looks back
  const int ew = t0 + warp * 32 * kVec;
  int32_t vals[kVec];
  load_kept(vals, in.p[0] + row + ew + lane, bits, lane);

  if (warp == 0) {
    const int wv = lane < kWarps ? s_warp[lane] : 0;
    int ws = wv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, ws, d);
      if (lane >= d) ws += y;
    }
    const int total = __shfl_sync(kFull, ws, kWarps - 1);
    if (lane < kWarps) s_warp[lane] = ws - wv;
    const int excl = look_back(status + (size_t)b * T, t, total, epoch);
    if (lane == 0) {
      if (t == T - 1) totals[b] = excl + total;
      s_base = excl;
      s_total = excl + total;
    }
  }
  __syncthreads();

  // route and array 0, then arrays 1..k-1 (each loaded whole before its
  // stores: a store to `out` could alias a later load, so the compiler
  // would otherwise wait out each load in turn)
  const int base = s_base + s_warp[warp];  // rank of the warp's first kept
  store_kept(vals, out + orow, base, bits, lane, cap, route + row + ew,
             N - ew);
#pragma unroll
  for (int a = 1; a < kMaxArrays; ++a) {
    if (a < k) {
      load_kept(vals, in.p[a] + row + ew + lane, bits, lane);
      store_kept(vals, out + a * plane + orow, base, bits, lane, cap,
                 nullptr, 0);
    }
  }

  if (t == T - 1 && s_total < cap) {
#pragma unroll
    for (int a = 0; a < kMaxArrays; ++a)
      if (a < k) fill_range(out + a * plane + orow, s_total, cap, fill);
  }
}

__global__ void __launch_bounds__(kThreads)
route_expand_kernel(const int32_t* dense, const int32_t* route,
                    const uint8_t* mask, int N, int cap, int32_t* out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= N) return;
  const int b = blockIdx.y;
  const size_t i = (size_t)b * N + j;
  const int r = route[i];
  out[i] = (mask[i] != 0 && r >= 0 && r < cap) ? dense[(size_t)b * cap + r]
                                                : 0;
}

}  // namespace

extern "C" {

// Status words (64-bit) td_compact_record needs for a (B, N) mask.
long long td_record_status_words(int B, int N) {
  return (long long)B * ((N + kTile - 1) / kTile);
}

// mask (B, N) uint8 (nonzero: keep); in0..in7 the k (B, N) int32 inputs
// (1 <= k <= 8, the rest unused); out (k, B, cap) int32; route (B, N)
// int32; totals (B,) int32. status and epoch as for td_compact_by_mask
// (compact.cu): at least td_record_status_words(B, N) words that only this
// kernel writes, zeroed before their first use, and an epoch in [1, 2^30)
// unlike that of the launch before on the same words; launches that share
// `status` must not overlap. N, cap >= 1. One launch.
int td_compact_record(const void* mask, int B, int N, const void* in0,
                      const void* in1, const void* in2, const void* in3,
                      const void* in4, const void* in5, const void* in6,
                      const void* in7, int k, int cap, int fill, void* out,
                      void* route, void* totals, void* status,
                      unsigned epoch, void* stream) {
  const long long blocks = td_record_status_words(B, N);
  if (k < 1 || k > kMaxArrays || N < 1 || cap < 1 || B < 1 ||
      blocks > INT_MAX || epoch == 0u || epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  const Ins in{{(const int32_t*)in0, (const int32_t*)in1,
                (const int32_t*)in2, (const int32_t*)in3,
                (const int32_t*)in4, (const int32_t*)in5,
                (const int32_t*)in6, (const int32_t*)in7}};
  record_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, N, (N + kTile - 1) / kTile, in, k, cap, fill,
      (int32_t*)out, (long long)B * cap, (int32_t*)route, (int32_t*)totals,
      (unsigned long long*)status, epoch);
  return (int)cudaGetLastError();
}

// dense (B, cap) int32, route (B, N) int32, mask (B, N) uint8, out (B, N)
// int32: out[b, j] = dense[b, route[b, j]] where mask[b, j] and
// 0 <= route[b, j] < cap, else 0. N, cap >= 1, B <= 65535.
int td_expand_route(const void* dense, const void* route, const void* mask,
                    int B, int N, int cap, void* out, void* stream) {
  if (N < 1 || cap < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  route_expand_kernel<<<dim3((N + kThreads - 1) / kThreads, B), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)dense, (const int32_t*)route, (const uint8_t*)mask, N,
      cap, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
