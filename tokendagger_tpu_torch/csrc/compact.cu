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
// what it is on any GPU: a count pass (one block per 8192 elements, one
// popcount per 32) and a scatter pass (the same blocks add the counts of
// the tiles before them, scan their threads' counts, and write each kept
// element at its rank). Output is dense at once, so there is no gap to
// remove. The piece geometry (length = next start - start, the last live
// piece ending at nbytes) and the four key words (the piece's first 16
// bytes, masked to its length) are one more pass over the p_cap slots.
//
// What bounds them on the H100: bytes. K2+K3 read the packed flags (N/8
// bytes per window) and write 6 int32 per slot (24 * p_cap bytes); K4
// reads and writes each kept value once. Their work per byte is a few
// integer operations, far below the card's ratio of operations to bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxArrays = 8;

__device__ __forceinline__ uint32_t valid_word(int u, int m) {
  const long long t = (long long)m - 32LL * u;
  if (t >= 32) return 0xFFFFFFFFu;
  if (t <= 0) return 0u;
  return (1u << (uint32_t)t) - 1u;
}

// Exclusive block scan of one int per thread; *total gets the block sum.
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    __syncwarp();
    if (lane < nw) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  *total = s_warp[nw - 1];
  __syncthreads();  // s_warp is reused by the next call
  return before + x - v;
}

// Sum of counts[0 .. n) by the whole block.
__device__ int block_sum_prefix(const int* counts, int n) {
  int v = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v += counts[i];
  int total;
  block_excl_scan(v, &total);
  return total;
}

// Start flags of chars 32u .. 32u+31 below nbytes, bit t = char 32u+t.
// packed: (N/32) plane-major words, bit j of word w = char j*C + w.
__device__ __forceinline__ uint32_t start_bits(const void* flags, int packed,
                                               int N, int u, int nbytes) {
  if (32 * u >= N) return 0u;
  uint32_t m = 0u;
  if (packed) {
    const uint32_t* W = (const uint32_t*)flags;
    const int C = N / 32;
    const int j = (32 * u) / C, w0 = (32 * u) % C;
#pragma unroll 8
    for (int t = 0; t < 32; ++t) m |= ((W[w0 + t] >> j) & 1u) << t;
  } else {
    const uint32_t* d4 = (const uint32_t*)flags + 8 * u;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint32_t four = d4[q];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m |= (((four >> (8 * k)) & 0xFFu) != 0u ? 1u : 0u) << (4 * q + k);
    }
  }
  return m & valid_word(u, nbytes);
}

__global__ void __launch_bounds__(kThreads)
starts_count_kernel(const void* flags, int packed, const int32_t* nbytes,
                    int N, int T, int32_t* counts) {
  const int t = blockIdx.x, b = blockIdx.y;
  const size_t fstride = packed ? (size_t)N / 8 : (size_t)N;
  const void* f = (const uint8_t*)flags + (size_t)b * fstride;
  const int u = t * kThreads + threadIdx.x;
  const int c = __popc(start_bits(f, packed, N, u, nbytes[b]));
  int total;
  block_excl_scan(c, &total);
  if (threadIdx.x == 0) counts[b * T + t] = total;
}

__global__ void __launch_bounds__(kThreads)
starts_scatter_kernel(const void* flags, int packed, const int32_t* nbytes,
                      int N, int T, const int32_t* counts, int p_cap,
                      int32_t* start_b, int32_t* n_pieces) {
  const int t = blockIdx.x, b = blockIdx.y;
  const size_t fstride = packed ? (size_t)N / 8 : (size_t)N;
  const void* f = (const uint8_t*)flags + (size_t)b * fstride;
  const int base = block_sum_prefix(counts + b * T, t);
  const int u = t * kThreads + threadIdx.x;
  uint32_t m = start_bits(f, packed, N, u, nbytes[b]);
  int total;
  int pos = base + block_excl_scan(__popc(m), &total);
  int32_t* sb = start_b + (size_t)b * p_cap;
  while (m && pos < p_cap) {
    const int bit = __ffs(m) - 1;
    sb[pos++] = 32 * u + bit;
    m &= m - 1u;
  }
  if (t == T - 1 && threadIdx.x == 0) n_pieces[b] = base + total;
}

__global__ void __launch_bounds__(kThreads)
piece_keys_kernel(const uint8_t* data, const int32_t* nbytes, int N,
                  int p_cap, const int32_t* n_pieces, int32_t* start_b,
                  int32_t* piece_len, int32_t* k0, int32_t* k1, int32_t* k2,
                  int32_t* k3) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= p_cap) return;
  const int nb = nbytes[b];
  const int kept = min(n_pieces[b], p_cap);
  const size_t o = (size_t)b * p_cap + j;
  uint32_t key[4] = {0u, 0u, 0u, 0u};
  int len = 0;
  if (j < kept) {
    const int s = start_b[o];
    const int e = j + 1 < kept ? start_b[o + 1] : nb;
    len = e - s;
    // the piece's first 16 bytes; the window's bytes end at N
    const uint8_t* d = data + (size_t)b * N;
    const int nk = min(min(len, 16), N - s);
    for (int i = 0; i < nk; ++i)
      key[i >> 2] |= (uint32_t)d[s + i] << (8 * (i & 3));
  } else {
    start_b[o] = nb;
  }
  piece_len[o] = len;
  k0[o] = (int32_t)key[0];
  k1[o] = (int32_t)key[1];
  k2[o] = (int32_t)key[2];
  k3[o] = (int32_t)key[3];
}

struct Arrays {
  const int32_t* in[kMaxArrays];
  int32_t* out[kMaxArrays];
};

// Keep flags of elements 32u .. 32u+31 of a (P,) bool row.
__device__ __forceinline__ uint32_t keep_bits(const uint8_t* mask, int P,
                                              int u) {
  uint32_t m = 0u;
  for (int e = 0; e < 32; ++e) {
    const int i = 32 * u + e;
    if (i < P && mask[i]) m |= 1u << e;
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
mask_count_kernel(const uint8_t* mask, int P, int T, int32_t* counts) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int u = t * kThreads + threadIdx.x;
  const int c = __popc(keep_bits(mask + (size_t)b * P, P, u));
  int total;
  block_excl_scan(c, &total);
  if (threadIdx.x == 0) counts[b * T + t] = total;
}

__global__ void __launch_bounds__(kThreads)
mask_scatter_kernel(const uint8_t* mask, int P, int T, const int32_t* counts,
                    Arrays arr, int k, int32_t fill) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int base = block_sum_prefix(counts + b * T, t);
  const int kept = base + block_sum_prefix(counts + b * T + t, T - t);
  const int u = t * kThreads + threadIdx.x;
  uint32_t m = keep_bits(mask + (size_t)b * P, P, u);
  int total;
  int pos = base + block_excl_scan(__popc(m), &total);
  const size_t row = (size_t)b * P;
  while (m) {
    const int i = 32 * u + __ffs(m) - 1;
    for (int a = 0; a < k; ++a) arr.out[a][row + pos] = arr.in[a][row + i];
    ++pos;
    m &= m - 1u;
  }
  // slots past the kept count, within this block's slice of the output
  for (int e = 0; e < 32; ++e) {
    const int i = 32 * u + e;
    if (i < P && i >= kept)
      for (int a = 0; a < k; ++a) arr.out[a][row + i] = fill;
  }
}

}  // namespace

extern "C" {

int td_compact_tiles(int n) { return (n + kTile - 1) / kTile; }

// flags: (B, N) uint8 (packed = 0) or (B, N/32) uint32 plane-major words
// (packed = 1); data (B, N) uint8; nbytes (B,) int32; counts scratch
// (B, td_compact_tiles(N)) int32; outputs (B, p_cap) int32 x 6 and (B,).
int td_compact_piece_keys(const void* flags, int packed, const void* data,
                          const void* nbytes, int B, int N, int p_cap,
                          void* counts, void* start_b, void* piece_len,
                          void* k0, void* k1, void* k2, void* k3,
                          void* n_pieces, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = td_compact_tiles(N);
  const int32_t* nb = (const int32_t*)nbytes;
  starts_count_kernel<<<dim3(T, B), kThreads, 0, s>>>(
      flags, packed, nb, N, T, (int32_t*)counts);
  starts_scatter_kernel<<<dim3(T, B), kThreads, 0, s>>>(
      flags, packed, nb, N, T, (const int32_t*)counts, p_cap,
      (int32_t*)start_b, (int32_t*)n_pieces);
  piece_keys_kernel<<<dim3((p_cap + kThreads - 1) / kThreads, B), kThreads,
                      0, s>>>(
      (const uint8_t*)data, nb, N, p_cap, (const int32_t*)n_pieces,
      (int32_t*)start_b, (int32_t*)piece_len, (int32_t*)k0, (int32_t*)k1,
      (int32_t*)k2, (int32_t*)k3);
  return (int)cudaGetLastError();
}

// mask (B, P) uint8; ins/outs: k pointers to (B, P) int32 (k <= 8);
// counts scratch (B, td_compact_tiles(P)) int32.
int td_compact_by_mask(const void* mask, int B, int P, void* const* ins,
                       void* const* outs, int k, int fill, void* counts,
                       void* stream) {
  if (k < 1 || k > kMaxArrays) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = td_compact_tiles(P);
  Arrays arr;
  for (int a = 0; a < kMaxArrays; ++a) {
    arr.in[a] = a < k ? (const int32_t*)ins[a] : nullptr;
    arr.out[a] = a < k ? (int32_t*)outs[a] : nullptr;
  }
  mask_count_kernel<<<dim3(T, B), kThreads, 0, s>>>(
      (const uint8_t*)mask, P, T, (int32_t*)counts);
  mask_scatter_kernel<<<dim3(T, B), kThreads, 0, s>>>(
      (const uint8_t*)mask, P, T, (const int32_t*)counts, arr, k, fill);
  return (int)cudaGetLastError();
}

}  // extern "C"
