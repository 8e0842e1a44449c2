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
// what it is on any GPU. K2+K3: a count pass (one block per 8192 elements,
// one popcount per 32) and a scatter pass (the same blocks add the counts of
// the tiles before them, scan their threads' counts, and write each kept
// element at its rank). Output is dense at once, so there is no gap to
// remove. The piece geometry (length = next start - start, the last live
// piece ending at nbytes) and the four key words (the piece's first 16
// bytes, masked to its length) are one more pass over the p_cap slots.
// K4: one pass (mask_compact_kernel): each block ranks its tile and finds
// the count before it by decoupled look-back over per-tile status words,
// so every mask byte is read once, in 16-byte loads, and every store of a
// warp lands on consecutive slots. Measured by chip_smoke.py (H100 80GB
// HBM3, 700 W): 0.031 ms at (8, 349,568) with k = 2, against a 0.008 ms
// bound and masked_select's 0.057 ms; 0.055 ms at (1, 4,194,304), bound
// 0.020 ms. At these sizes every block's chain of latencies (fill, fence,
// status, look-back, the kept loads) outweighs its bytes.
//
// What bounds them on the H100: bytes. K2+K3 read the packed flags (N/8
// bytes per window) and write 6 int32 per slot (24 * p_cap bytes); K4
// reads the mask and each kept value once and writes every output slot
// (kept slots twice: the fill first). Their work per byte is a few
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

// ---- K4 ----

constexpr int kMaskThreads = 256;
constexpr int kMaskVec = 16;                        // mask bytes per thread
constexpr int kMaskTile = kMaskThreads * kMaskVec;  // elements per block
constexpr uint32_t kAgg = 1u, kIncl = 2u;           // tile status flags

struct Ins {
  const int32_t* p[kMaxArrays];
};

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
    const uint32_t tag_agg = epoch << 2 | kAgg, tag_incl = epoch << 2 | kIncl;
    unsigned long long* st = status + (size_t)b * T;
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
        const uint32_t incl = __ballot_sync(0xFFFFFFFFu, tag == tag_incl);
        const int first = incl ? __ffs(incl) - 1 : 31;
        int v = lane <= first && i >= 0 ? (int)(uint32_t)s : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
        excl += v;
        if (incl) break;
      }
    }
    if (lane == 0) {
      put_status(st + t, tag_incl, excl + total);
      s_base = excl;
    }
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
