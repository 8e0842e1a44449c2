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
//   ops/merge.py. The row's routines live in merge_row.cuh, which the CPU
//   tests also build for the host (merge_host.cpp).
//
// The JAX version advances all rows in lockstep with one-hot reductions,
// because XLA lowers (row, col)-indexed scatters to a sequential loop on
// the TPU. A row's merges are a chain (each merge's new pairs may be the
// next minimum), so rows are the parallelism here.
//
// What bounds it on the H100. The first design (a warp a row, lanes 0-1
// looking up) was not latency-bound, as its note said: clock64 around
// each phase of its merge step, on an H100 SXM at 700 W, gave per step
// and warp a scan of the row 257-572 cycles, the 64-bit shuffle
// min-reduce 285-406, the chain of shared reads 194-299, and the two
// lookups with the writes
// 1,235-6,475 (52-89% of the step) at the piece path's and the window
// caps' shapes, with 62 warps an SM sharing its schedulers and its L1. So
// the pair-table lookups bound it: every lookup issued six 16-byte loads
// (both 48-byte candidate rows), each a request the L1 serves one line at
// a time and L2 answers, and a row's lookups were spread over a warp of
// which 30 lanes idled, with ~100 warp instructions a step.
//
// The design (merge_rows_group<G>): G lanes a row, 32 / G rows a warp.
// * Lane j owns the row's columns j, j + G, ... and caches their leftmost
//   minimum (rank, column). The row's leftmost minimum is the first of its
//   lanes' (before()): two __reduce_min_sync (rank, then column among the
//   lanes holding it) when G = 32, log2 G rounds of two shuffles else.
//   After a merge only the lanes owning p, b or b2 take theirs again.
// * Lanes 0 and 1 of a row make its two lookups at once, so 32 / G rows'
//   lookups share each warp instruction. A lookup loads the two candidate
//   rows' key quads (four 16-byte loads) and then the values of the row
//   that holds the key only: a miss costs four requests, not six, and a
//   dead neighbour none (merge_row.cuh).
// * The first round runs in three passes whose loads are independent
//   (bytes, ids with the lut's ranks, the table's ranks two at a time), so
//   a lane waits about three round trips, not three a column.
// * Rows sit rs = C + pad apart with rs = G (mod 32) when G < 32, so the
//   lanes of a warp reading their k-th columns hit distinct banks. Links
//   are bytes, so a row costs 10 B a column. A lane takes its minimum
//   with all its loads in flight (lane_min's bound K: 4 columns for
//   16-byte rows at 4 lanes, 16 for 64-byte rows).
// * G falls as rows grow (lanes_per_row): with few rows, more lanes a row
//   shorten each row's chain and keep the card's warps busy; with many, 4
//   lanes a row (8 rows a warp) cut the instructions and requests a merge
//   costs. Rows over 64 bytes take a warp.
// What bounds it now: still the lookups. clock64 on this design (same
// card and shapes) gives per step and warp the reduction 160-350 cycles,
// the shared reads 210-450, the lookups with the writes 990-3,060 (55-79%
// of the step) and the lanes' minima 355-820; the first round takes 5-43%
// of a warp's time (most where there is no lut and rows are many). With
// 8,192 rows and fewer, and at 256-byte rows, the time is the longest
// rows' chains of such steps. PERF.md section 6 has the times beside the
// bytes bound and the latency floor (the longest row's merges times one
// dependent L2 read).
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_row.cuh"

namespace {

using td_merge::kMaxRank;
using td_merge::Row;

constexpr int kGroupThreads = 256;  // threads a block
constexpr unsigned kFull = 0xFFFFFFFFu;

// Lanes a row: 32 for rows over 64 bytes and for up to 2,048 rows; 8 up to
// 8,192 rows; 4 beyond. Measured on the H100 (PERF.md section 6): of 4, 8,
// 16 and 32 lanes, each is the fastest (or within 1% of it) at 2,048 to
// 262,144 rows of 16 and 64 bytes where it is taken.
int lanes_per_row(long long R, int C) {
  if (C > 64 || R <= 2048) return 32;
  return R <= 8192 ? 8 : 4;
}

// G lanes a row, 32 / G rows a warp. Lane j of a row owns its columns j,
// j + G, ... and caches their leftmost minimum (rank, column); the row's
// leftmost minimum is a reduction over the row's lanes. Rows are kept
// rs = C + pad elements apart, rs = G (mod 32) when G < 32, so that the
// lanes of a warp reading their j-th columns hit distinct banks.
template <int G>
__global__ void __launch_bounds__(kGroupThreads)
merge_rows_group(const uint8_t* __restrict__ bytes,
                 const int* __restrict__ lengths, int R, int C, int rs,
                 const int* __restrict__ byte_rank,
                 const int* __restrict__ rows, unsigned mask,
                 const int* __restrict__ lut, int* __restrict__ tok_out,
                 int* __restrict__ counts) {
  constexpr int kRows = kGroupThreads / G;
  // columns a lane owns, at most: in any row, and in rows of <= 16 bytes
  constexpr int K = (G == 32 ? 256 : 64) / G, K16 = G >= 16 ? 1 : 16 / G;
  extern __shared__ int smem[];
  const int j = threadIdx.x % G, g = threadIdx.x / G;
  const long long row = (long long)blockIdx.x * kRows + g;
  // whole warps past the last row leave; the others keep every lane, for
  // the shuffles, and their rows past R are empty
  if ((long long)blockIdx.x * kRows + (threadIdx.x & ~31) / G >= R) return;
  const bool valid = row < R;
  const int n = kRows * rs;
  uint8_t* links = reinterpret_cast<uint8_t*>(smem + 2 * n);
  const int at = g * rs;
  const Row<1> st{smem + at, smem + n + at, links + at, links + n + at};
  const uint8_t* src = bytes + (valid ? row : 0) * C;
  const int L = valid ? min(max(lengths[row], 0), C) : 0;

  td_merge::init_row(st, src, L, C, j, G, byte_rank, rows, mask, lut,
                     [] { __syncwarp(); });
  int mr, mc;  // this lane's leftmost minimum (rank, column)
  const auto own_min = [&] {
    if (C <= 16)
      td_merge::lane_min<K16>(st, j, G, C, mr, mc);
    else
      td_merge::lane_min<K>(st, j, G, C, mr, mc);
  };
  own_min();

  while (true) {
    int v, b;  // the row's leftmost minimum
    if constexpr (G == 32) {
      v = __reduce_min_sync(kFull, mr);
      if (v == kMaxRank) break;
      b = __reduce_min_sync(kFull, mr == v ? mc : C);
    } else {
      v = mr;
      b = mc;
#pragma unroll
      for (int o = 1; o < G; o <<= 1) {
        const int ov = __shfl_xor_sync(kFull, v, o);
        const int ob = __shfl_xor_sync(kFull, b, o);
        if (td_merge::before(ov, ob, v, b)) { v = ov; b = ob; }
      }
      if (!__any_sync(kFull, v != kMaxRank)) break;
    }
    const bool go = v != kMaxRank;  // rows of a warp end at their own step
    td_merge::Step s{};
    if (go) s = td_merge::read_step(st, b, v);
    __syncwarp();  // every lane has read before lanes 0 and 1 write
    if (go && j < 2) {
      // lane 0 looks up (b, b3) and lane 1 (p, b): one instruction stream
      const int r = td_merge::lookup(rows, mask, j ? s.tp : v,
                                     j ? v : s.t3);
      if (j == 0)
        td_merge::splice(st, s, r);
      else if (s.p >= 0)
        st.p(s.p) = r;
    }
    __syncwarp();
    if (go && td_merge::touched(s, j, G)) own_min();
  }

  int live = 0;
  if (valid) {
    int* out = tok_out + row * C;
    if (G < 32 && (C & 3) == 0) {
      // 16 bytes a lane: rs and C are multiples of 4, so both sides align
      for (int c = 4 * j; c < C; c += 4 * G) {
        const int4 t = *reinterpret_cast<const int4*>(&st.t(c));
        *reinterpret_cast<int4*>(out + c) = t;
        live += (t.x >= 0) + (t.y >= 0) + (t.z >= 0) + (t.w >= 0);
      }
    } else {
      for (int c = j; c < C; c += G) {
        const int t = st.t(c);
        out[c] = t;
        live += t >= 0;
      }
    }
  }
  if constexpr (G == 32) {
    live = __reduce_add_sync(kFull, live);
  } else {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) live += __shfl_xor_sync(kFull, live, o);
  }
  if (valid && j == 0) counts[row] = live;
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
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* b = (const uint8_t*)bytes;
  const int* ln = (const int*)lengths;
  const int* br = (const int*)byte_rank;
  const int* pt = (const int*)rows;
  const int* lt = (const int*)lut;
  int* tk = (int*)tok;
  int* ct = (int*)counts;
  const int G = lanes_per_row(R, C);
  const int rows_b = kGroupThreads / G;
  const int rs = G == 32 ? C : C + ((G - C) % 32 + 32) % 32;
  const unsigned blocks = (unsigned)((R + rows_b - 1) / rows_b);
  const size_t shared = (size_t)rows_b * rs * 10;  // 10 B a column
  auto kernel = G == 32 ? merge_rows_group<32>
                        : (G == 8 ? merge_rows_group<8> : merge_rows_group<4>);
  kernel<<<blocks, kGroupThreads, shared, st>>>(b, ln, R, C, rs, br, pt, mask,
                                                lt, tk, ct);
  return (int)cudaGetLastError();
}

// The lanes td_merge_rows gives each row of an (R, C) call.
int td_merge_lanes(int R, int C) { return lanes_per_row(R, C); }

// next: a permutation table (int32) holding one cycle; out: one int32.
int td_l2_chase(const void* next, int steps, void* out, void* stream) {
  l2_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                                     (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
