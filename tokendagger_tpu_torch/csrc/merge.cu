// The device BPE merge: (R, C) pretoken byte rows -> token ids per row.
//
// Replaces the XLA while-loop of tokendagger_tpu/ops/merge.py:96
// (merge_rows_from_state, entered through merge_rows_local at :68; there
// is no pallas_call). Per row of length L = min(lengths[r], C):
//   tok[c] = byte_rank[byte c] (c < L, else -1); pr[c] = rank of the pair
//   (c, c+1) for c < L-1 (from pair_lut when given, else the pair table),
//   MAX otherwise; then, until no pair has a rank: take the leftmost
//   minimum pr[b], merge b with its right part b2 (the pair's rank is the
//   merged id), unlink b2, and look up the two pairs around the merged
//   part (prev p, b) and (b, next b3). Output: tok (-1 at dead slots) and
//   the count of live parts. Bit-identical to the plain loop in
//   ops/merge.py.
//
// The JAX version advances all rows in lockstep with one-hot reductions,
// because XLA lowers (row, col)-indexed scatters to a sequential loop on
// the TPU. Here one warp owns one row: the row's tok/pr/nxt/prv live in
// shared memory (4 KB at C = 256), the lanes reduce (rank, column) to the
// leftmost minimum with shuffles, lane 0 makes the pointer splice, and
// lanes 0 and 1 make the two pair lookups at once (the same instructions,
// each on its own pair). Each lookup issues both candidate 48-byte rows
// of the two-choice table before comparing, so it costs one round trip to
// L2, where a hot table stays.
//
// What bounds it on the H100: not bytes. A row's merges are a chain, each
// a full-row scan, a 64-bit warp min-reduce, three dependent shared reads
// and an L2 round trip; the batch takes about its longest row's chain
// when the card holds all rows at once. Its floor is that row's merges
// times one dependent L2 read; the per-merge instructions put it above
// (PERF.md section 6 has both figures).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows per block
constexpr int kMaxRank = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned mix(int a, int b, unsigned c1,
                                        unsigned c2, unsigned c3,
                                        unsigned mask) {
  unsigned h = (unsigned)a * c1 + (unsigned)b * c2;
  h ^= h >> 16;
  h *= c3;
  h ^= h >> 15;
  return h & mask;
}

__device__ __forceinline__ int match(int4 ka, int4 kb, int4 va, int a,
                                     int b) {
  int v = -1;
  if (ka.x == a && kb.x == b) v = max(v, va.x);
  if (ka.y == a && kb.y == b) v = max(v, va.y);
  if (ka.z == a && kb.z == b) v = max(v, va.z);
  if (ka.w == a && kb.w == b) v = max(v, va.w);
  return v;
}

// rank(bytes(a) + bytes(b)) from the (nb, 12) pair table, MAX if none.
__device__ int lookup(const int* __restrict__ rows, unsigned mask, int a,
                      int b) {
  if (a < 0 || b < 0) return kMaxRank;
  const unsigned h0 = mix(a, b, 0x9E3779B1u, 0x85EBCA77u, 0x7FEB352Du, mask);
  const unsigned h1 = mix(a, b, 0xC2B2AE3Du, 0x27D4EB2Fu, 0x165667B1u, mask);
  const int4* r0 = reinterpret_cast<const int4*>(rows + (size_t)h0 * 12);
  const int4* r1 = reinterpret_cast<const int4*>(rows + (size_t)h1 * 12);
  const int4 a0 = __ldg(r0), b0 = __ldg(r0 + 1), v0 = __ldg(r0 + 2);
  const int4 a1 = __ldg(r1), b1 = __ldg(r1 + 1), v1 = __ldg(r1 + 2);
  const int first = match(a0, b0, v0, a, b);
  if (first >= 0) return first;
  const int second = match(a1, b1, v1, a, b);
  return second >= 0 ? second : kMaxRank;
}

__global__ void __launch_bounds__(kWarps * 32)
merge_rows_kernel(const uint8_t* __restrict__ bytes,
                  const int* __restrict__ lengths, int R, int C,
                  const int* __restrict__ byte_rank,
                  const int* __restrict__ rows, unsigned mask,
                  const int* __restrict__ lut, int* __restrict__ tok_out,
                  int* __restrict__ counts) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= R) return;  // whole warps leave; the block never syncs
  int* tok = smem + warp * 4 * C;
  int* pr = tok + C;
  int* nxt = pr + C;
  int* prv = nxt + C;
  const uint8_t* src = bytes + row * C;
  const int L = min(max(lengths[row], 0), C);

  for (int c = lane; c < C; c += 32) {
    int t = -1, r = kMaxRank;
    if (c < L) t = byte_rank[src[c]];
    if (c < L - 1) {
      r = lut != nullptr ? lut[src[c] * 256 + src[c + 1]]
                         : lookup(rows, mask, t, byte_rank[src[c + 1]]);
    }
    tok[c] = t;
    pr[c] = r;
    nxt[c] = c < L - 1 ? c + 1 : C;
    prv[c] = (c > 0 && c < L) ? c - 1 : C;
  }
  __syncwarp();

  while (L >= 2) {
    // leftmost minimum: (rank, column) as one key, the smallest wins
    unsigned long long best = ~0ull;
    for (int c = lane; c < L; c += 32) {
      const unsigned long long k =
          ((unsigned long long)(unsigned)pr[c] << 32) | (unsigned)c;
      best = k < best ? k : best;
    }
    for (int o = 16; o; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, best, o);
      best = other < best ? other : best;
    }
    const int v = (int)(best >> 32);
    if (v == kMaxRank) break;
    const int b = (int)(best & 0xFFFFFFFFull);
    const int b2 = nxt[b];
    const int b3 = b2 < C ? nxt[b2] : C;
    const int p = prv[b];
    const int t3 = b3 < C ? tok[b3] : -1;
    const int tp = p < C ? tok[p] : -1;
    __syncwarp();
    if (lane < 2) {
      // lane 0 looks up (b, b3) and lane 1 (p, b): one instruction stream
      const int r = lookup(rows, mask, lane == 0 ? v : tp,
                           lane == 0 ? t3 : v);
      if (lane == 0) {
        tok[b] = v;
        if (b2 < C) {
          tok[b2] = -1;
          pr[b2] = kMaxRank;
        }
        nxt[b] = b3;
        if (b3 < C) prv[b3] = b;
        pr[b] = r;
      } else if (p < C) {
        pr[p] = r;
      }
    }
    __syncwarp();
  }

  int live = 0;
  for (int c = lane; c < C; c += 32) {
    const int t = tok[c];
    tok_out[row * C + c] = t;
    live += t >= 0;
  }
  live = __reduce_add_sync(kFull, live);
  if (lane == 0) counts[row] = live;
}

// One thread walks a pointer chain: the latency of a dependent read that
// hits L2 (loads bypass L1).
__global__ void l2_chase_kernel(const int* __restrict__ next, int steps,
                                int* out) {
  int i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;
}

}  // namespace

extern "C" {

// bytes (R, C) uint8, lengths (R,) int32, byte_rank (256,) int32, rows the
// (mask + 1, 12) int32 pair table (16-byte aligned), lut (256, 256) int32
// or null; writes tok (R, C) int32 and counts (R,) int32. C <= 256.
int td_merge_rows(const void* bytes, const void* lengths, int R, int C,
                  const void* byte_rank, const void* rows, unsigned mask,
                  const void* lut, void* tok, void* counts, void* stream) {
  if (R <= 0) return 0;
  if (C < 1 || C > 256) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((R + kWarps - 1) / kWarps);
  const size_t shared = (size_t)kWarps * 4 * C * sizeof(int);
  merge_rows_kernel<<<blocks, kWarps * 32, shared, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int*)lengths, R, C,
      (const int*)byte_rank, (const int*)rows, mask, (const int*)lut,
      (int*)tok, (int*)counts);
  return (int)cudaGetLastError();
}

// next: a permutation table (int32) holding one cycle; out: one int32.
int td_l2_chase(const void* next, int steps, void* out, void* stream) {
  l2_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                                     (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
