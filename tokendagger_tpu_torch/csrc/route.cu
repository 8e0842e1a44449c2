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
// the kept elements of its row, -1 off the mask. The compaction is a count
// pass and a scatter pass, one block per 8192 elements; a warp takes 1024
// consecutive elements 32 at a time and ranks them with one ballot and a
// popcount, so every load and store of a warp is to consecutive addresses.
// The expansion is one gather pass, out[j] = dense[route[j]], with nothing
// to clear first.
//
// What bounds them on the H100: bytes. K5+K6 read the mask (1 byte per
// element) and the kept values, and write the dense prefix and the route
// (4 bytes per element); K7+K8 read the route, the mask and the values they
// fetch, and write 4 bytes per element. Each does a few integer operations
// per byte, far below the card's ratio of operations to bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 32 * 32;
constexpr int kTile = kWarps * kPerWarp;
constexpr int kMaxArrays = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Arrays {
  const int32_t* in[kMaxArrays];
  int32_t* out[kMaxArrays];
};

// Kept elements among the 1024 from `first` of a row (whole warp).
__device__ __forceinline__ int warp_count(const uint8_t* mask, int N,
                                          int first) {
  const int lane = threadIdx.x & 31;
  int c = 0;
  for (int r = 0; r < 32; ++r) {
    const int i = first + 32 * r + lane;
    c += __popc(__ballot_sync(kFull, i < N && mask[i] != 0));
  }
  return c;
}

// Sum over the block of one int per thread; every thread gets it.
__device__ int block_sum(int v) {
  __shared__ int s[kWarps];
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  __syncthreads();  // s is reused by the next call
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s[w];
  return t;
}

__global__ void __launch_bounds__(kThreads)
route_count_kernel(const uint8_t* mask, int N, int T, int32_t* counts) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = warp_count(mask + (size_t)b * N, N,
                           t * kTile + warp * kPerWarp);
  const int total = block_sum(lane == 0 ? c : 0);
  if (threadIdx.x == 0) counts[(size_t)b * T + t] = total;
}

__global__ void __launch_bounds__(kThreads)
route_scatter_kernel(const uint8_t* mask, int N, int T, const int32_t* counts,
                     Arrays arr, int k, int cap, int32_t fill, int32_t* route,
                     int32_t* totals) {
  __shared__ int s_warp[kWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // kept elements of the row before this block, and in the whole row
  const int32_t* cb = counts + (size_t)b * T;
  int before = 0, all = 0;
  for (int i = threadIdx.x; i < T; i += kThreads) {
    all += cb[i];
    if (i < t) before += cb[i];
  }
  before = block_sum(before);
  all = block_sum(all);
  const uint8_t* m = mask + (size_t)b * N;
  const int first = t * kTile + warp * kPerWarp;
  const int c = warp_count(m, N, first);
  if (lane == 0) s_warp[warp] = c;
  __syncthreads();
  int pos = before;
  for (int w = 0; w < warp; ++w) pos += s_warp[w];
  const size_t row = (size_t)b * N, orow = (size_t)b * cap;
  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < 32; ++r) {
    const int i = first + 32 * r + lane;
    const bool keep = i < N && m[i] != 0;
    const unsigned bal = __ballot_sync(kFull, keep);
    if (i < N) {
      const int rank = pos + __popc(bal & below);
      route[row + i] = keep ? rank : -1;
      if (keep && rank < cap)
        for (int a = 0; a < k; ++a) arr.out[a][orow + rank] = arr.in[a][row + i];
    }
    pos += __popc(bal);
  }
  // dense slots past the kept count, spread over the row's blocks
  for (long long s = (long long)min(all, cap) + t * kThreads + threadIdx.x;
       s < cap; s += (long long)T * kThreads)
    for (int a = 0; a < k; ++a) arr.out[a][orow + s] = fill;
  if (t == 0 && threadIdx.x == 0) totals[b] = all;
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

int td_route_tiles(int n) { return (n + kTile - 1) / kTile; }

// mask (B, N) uint8; ins: k pointers to (B, N) int32, outs: k pointers to
// (B, cap) int32 (1 <= k <= 8); counts scratch (B, td_route_tiles(N))
// int32; route (B, N) int32; totals (B,) int32. N, cap >= 1, B <= 65535.
int td_compact_record(const void* mask, int B, int N, void* const* ins,
                      void* const* outs, int k, int cap, int fill,
                      void* counts, void* route, void* totals, void* stream) {
  if (k < 1 || k > kMaxArrays || N < 1 || cap < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = td_route_tiles(N);
  Arrays arr;
  for (int a = 0; a < kMaxArrays; ++a) {
    arr.in[a] = a < k ? (const int32_t*)ins[a] : nullptr;
    arr.out[a] = a < k ? (int32_t*)outs[a] : nullptr;
  }
  route_count_kernel<<<dim3(T, B), kThreads, 0, s>>>(
      (const uint8_t*)mask, N, T, (int32_t*)counts);
  route_scatter_kernel<<<dim3(T, B), kThreads, 0, s>>>(
      (const uint8_t*)mask, N, T, (const int32_t*)counts, arr, k, cap, fill,
      (int32_t*)route, (int32_t*)totals);
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
