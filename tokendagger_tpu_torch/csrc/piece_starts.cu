// K1: piece starts, bytes or codepoints -> plane-major start words.
//
// Replaces the Pallas kernel of tokendagger_tpu/ops/bitplane.py:1152
// (piece_starts_bits_pallas, kernel `kern` at :1137-1159, packed_out=True)
// together with the XLA mask construction in front of it, which is folded
// in here. Three entries share the derivation (starts_derive.cuh):
//   * td_piece_starts: ASCII windows of bytes, classes from a 128-entry
//     table (ascii_fast=True; _char_masks_planes, :462-545);
//   * td_piece_starts_cp: windows of codepoints (general text), classes
//     from the per-codepoint table of unicode_tables.char_class_words
//     (ascii_fast=False; _char_masks, :548-637). The JAX engine runs this
//     form as XLA (bitplane.py:1011-1045); here it is the same kernel.
//     The 2.2 MB table stays resident in the 50 MB L2;
//   * td_piece_starts_words: windows of per-char class words, as the
//     hot-codepoint class lookup gives them (ascii_fast=False with
//     hot_cps, :1111-1125; ops/bitplane.class_lookup_hot in the port).
//
// What bounds it on the H100: not bytes (a 1 MB window reads 1-4 MB and
// writes 128 KB) but the 162-166 dependent passes of the derivation
// (td_piece_starts_passes), each a sweep over the window's planes that may
// read any word of an earlier plane, so each pass ends in a barrier across
// everything that works on the window: the time is passes x (barrier
// latency + one sweep). Measured by chip_smoke.py: 0.98 ms for 8 windows
// of 1 MB (4.9 ms with one block per window), 0.82 ms for one 4 MB window
// (18.6 ms), 1.82 ms for 16 MB: about 5 us a pass, a quarter of it the
// barrier, the rest the L2 round trips of a sweep. The TPU
// held a window's class planes in VMEM (~1.5 MB); an SM has 227 KB of
// shared memory, so the ~40 planes of a window live in global memory,
// where the working set of 8 windows (~40 MB) stays in the 50 MB L2.
//
// Design: a cooperative launch of every block the card holds at once (2
// blocks of 512 threads per SM), shared out as S = blocks / B segments per
// window, one block per segment: segment s of window b owns words
// [s*C/S, (s+1)*C/S) of each plane (C = N/32), so the engine's single
// window runs on every SM and a batch of 8 on 33 blocks each. A batch of
// more windows than the card holds blocks (264 on the H100) runs as
// groups of at most that many windows, one block each, one cooperative
// launch per group on the same stream. A pass is:
//   * each: every block evaluates its own words, then the grid barrier
//     (cooperative_groups grid sync; every window runs the same pass
//     sequence, so one barrier serves all of them);
//   * scan: every block composes its segment's 1-bit map (a thread's word
//     in 5 shift steps, a warp's 32 words through two ballots, the warps
//     of a tile in shared memory, tile to tile in order) and publishes it;
//     after the barrier each block composes the maps of the segments
//     before it in scan order (after it, for a reverse scan) into its
//     carry-in, sweeps its words again with that carry and writes them;
//     then the barrier. The composition is associative, so the result is
//     bit for bit the sequential one (the host build's SegOps runs the
//     same order on the CPU).
//
// Why a grid barrier and this shape (H100 80GB HBM3 at 700 W): the grid
// barrier takes 1.15 us over 132 blocks and 1.38 us over 264, a cluster
// barrier 0.73-0.80 us (tools/barrier_probe.py); but a cluster caps a
// window at 16 SMs, and only 7 clusters of 16 one-per-SM blocks fit at
// once, so 8 windows would need two waves and the engine's one window
// would get 16 of 132 SMs. With the derivation's 162-166 passes, 1-2
// barriers each, the grid barrier costs ~0.3 ms of a call and buys every
// SM. Block shape (tools/k1_variants.py, codepoint entry): 512 x 2 per SM
// 1.014 ms at 8 x 1 M chars and 0.827 ms at 1 x 4 M; 1024 x 1 1.007 and
// 0.753; 512 x 1 (128 registers, no spills) 1.079 and 0.754; 256 x 4
// 1.121 and 1.085. 512 x 2 is kept: level at 8 windows, and its 264
// blocks still give every B up to 132 windows at least min(132, 16 B)
// blocks, which 132 blocks cannot (9 windows would get 126).
//
// Output: word w' bit j = start flag of char j*C + w', the reference's
// plane-major layout that compact.cu reads; each block transposes the
// 32x32-bit groups it owns with ballots.
//
// Row entry (td_piece_starts_cp_rows): the batched grids of short
// segments (ops/batched.py) give K1 thousands of rows of 256-4096 chars.
// Spread over segments with grid barriers, a (4096, 256) grid would run
// as 16 groups of 264 rows, each paying the ~165 barrier-separated
// passes. Instead each row is one ordinary block (one thread per word of
// a plane: 32 threads at 256 and 1024 chars, 128 at 4096) whose 48 planes
// live in dynamic shared memory (1.5 KB at 256 chars, 24 KB at 4096),
// with __syncthreads between passes (RowOps). A row of 256 chars has
// C = 8 words a plane, too few for the 32x32 ballot transpose, so each
// thread gathers its output word bit by bit (starts_derive.cuh
// plane_major_word, which the host build also runs). Measured by
// chip_smoke.py (H100 80GB HBM3, 700 W), device time: 0.162 ms at
// (4096, 256), 0.064 ms at (1024, 1024) and 0.065 ms at (256, 4096),
// where the window entry takes 2.000 and 0.509 ms on the same rows. What
// bounds it is the ~165 passes, not bytes: at 256 chars most of a
// block's threads idle in each pass.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "starts_derive.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxBlocks = 4096;
// row entry: rows of at most this many chars, one block of at most
// kRowThreads threads each (one thread per word of a plane)
constexpr int kRowMaxChars = 4096;
constexpr int kRowThreads = kRowMaxChars / 32;

// each block's segment map of the current scan (bit 0: z, bit 1: o), by
// window and position in scan order; rewritten by every scan
__device__ uint32_t g_agg[kMaxBlocks];

struct Lut {
  uint32_t v[128];
};

struct Shared {
  uint32_t wz[32], wo[32];  // warp maps of a tile
  uint32_t state[2 * 33];   // map entering each warp, double-buffered
  uint32_t carry;           // a segment's state at its start
};

// Methods are __host__ __device__ so that the derivation templates, which
// are too, instantiate cleanly in both compilation passes; the bodies exist
// only in device code.
struct GridOps {
  uint32_t* scratch;
  int C;
  int next;
  int lo, hi;    // this block's words of each plane
  int seg, S;    // its segment and the window's segment count
  uint32_t* agg; // the window's S segment maps
  Shared* sh;

  TD_FN uint32_t* plane() {
#ifdef __CUDA_ARCH__
    if (next >= td::STARTS_PLANES) __trap();
#endif
    return scratch + (size_t)(next++) * C;
  }

  template <class F>
  TD_FN void each(const F& f) {
#ifdef __CUDA_ARCH__
    for (int w = lo + threadIdx.x; w < hi; w += blockDim.x) f(w);
    cg::this_grid().sync();
#endif
  }

  // Sweeps this segment's words in scan order, entering with the 1-bit map
  // (cz, co); returns the map after the segment (bit 0: z, bit 1: o). With
  // `write` the entering map is a constant (cz == co: the state) and out
  // gets each word's states.
  template <class F>
  __device__ uint32_t segment(uint32_t* out, const F& f, bool rev,
                              uint32_t cz, uint32_t co, bool write) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nw = blockDim.x >> 5;
    const int len = hi - lo;
    uint32_t map = cz | co << 1;
    int t = 0;
    for (int base = 0; base < len; base += blockDim.x, ++t) {
      const int i = base + tid;
      const int w = rev ? hi - 1 - i : lo + i;
      uint32_t Z = 0u, O = 0xFFFFFFFFu;  // identity beyond the segment
      if (i < len) {
        const td::ZO v = f(w);
        Z = rev ? td::brev32(v.z) : v.z;
        O = rev ? td::brev32(v.o) : v.o;
      }
      td::zo_prefix(Z, O);
      // lanes' word maps -> inclusive prefix across the warp
      uint32_t wz = __ballot_sync(0xFFFFFFFFu, (Z >> 31) & 1u);
      uint32_t wo = __ballot_sync(0xFFFFFFFFu, (O >> 31) & 1u);
      td::zo_prefix(wz, wo);
      if (lane == 31) {
        sh->wz[warp] = wz >> 31;
        sh->wo[warp] = wo >> 31;
      }
      __syncthreads();
      uint32_t* st = sh->state + (t & 1) * 33;
      if (warp == 0) {
        const uint32_t ez = map & 1u, eo = map >> 1;
        uint32_t xz = __ballot_sync(0xFFFFFFFFu, lane < nw ? sh->wz[lane] : 0u);
        uint32_t xo = __ballot_sync(0xFFFFFFFFu, lane < nw ? sh->wo[lane] : 1u);
        td::zo_prefix(xz, xo);
        if (lane == 0) st[0] = map;
        if (lane < nw) {
          const uint32_t mz = (xz >> lane) & 1u, mo = (xo >> lane) & 1u;
          st[lane + 1] = (ez ? mo : mz) | (eo ? mo : mz) << 1;
        }
      }
      __syncthreads();
      map = st[nw];
      if (write && i < len) {
        const uint32_t cw = st[warp] & 1u;
        const uint32_t ct =
            lane == 0 ? cw : (((cw ? wo : wz) >> (lane - 1)) & 1u);
        const uint32_t s = ct ? O : Z;
        out[w] = rev ? td::brev32(s) : s;
      }
    }
    return map;
  }

  template <class F>
  TD_FN void scan(uint32_t* out, const F& f, bool rev) {
#ifdef __CUDA_ARCH__
    const int p = rev ? S - 1 - seg : seg;  // position in scan order
    const uint32_t m = segment(out, f, rev, 0u, 1u, false);
    if (threadIdx.x == 0) agg[p] = m;
    cg::this_grid().sync();
    // the state entering this segment: the maps before it, in scan order,
    // composed 32 at a time by the first warp
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      uint32_t c = 0u;
      for (int q0 = 0; q0 < p; q0 += 32) {
        const int q = q0 + lane;
        const uint32_t v = q < p ? __ldcg(agg + q) : 2u;  // identity
        uint32_t z = __ballot_sync(0xFFFFFFFFu, v & 1u);
        uint32_t o = __ballot_sync(0xFFFFFFFFu, (v >> 1) & 1u);
        td::zo_prefix(z, o);
        const int last = min(32, p - q0) - 1;
        c = ((c ? o : z) >> last) & 1u;
      }
      if (lane == 0) sh->carry = c;
    }
    __syncthreads();
    const uint32_t c = sh->carry;
    segment(out, f, rev, c, c, true);
    cg::this_grid().sync();
#endif
  }
};

// The row entry's backend: one block runs a whole row (at most
// kRowMaxChars chars) with its planes in shared memory; a pass ends in
// __syncthreads. A scan runs over tiles of blockDim words in order: a
// thread's word in 5 shift steps, a warp's 32 words through two ballots,
// the warps in shared memory, the state carried from tile to tile.
struct RowOps {
  uint32_t* planes;  // STARTS_PLANES x C words of dynamic shared memory
  int C;
  int next;
  Shared* sh;

  TD_FN uint32_t* plane() {
#ifdef __CUDA_ARCH__
    if (next >= td::STARTS_PLANES) __trap();
#endif
    return planes + (size_t)(next++) * C;
  }

  template <class F>
  TD_FN void each(const F& f) {
#ifdef __CUDA_ARCH__
    for (int w = threadIdx.x; w < C; w += blockDim.x) f(w);
    __syncthreads();
#endif
  }

  template <class F>
  TD_FN void scan(uint32_t* out, const F& f, bool rev) {
#ifdef __CUDA_ARCH__
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nw = blockDim.x >> 5;
    int t = 0;
    for (int base = 0; base < C; base += blockDim.x, ++t) {
      const int i = base + tid;
      const int w = rev ? C - 1 - i : i;
      uint32_t Z = 0u, O = 0xFFFFFFFFu;  // identity beyond the row
      if (i < C) {
        const td::ZO v = f(w);
        Z = rev ? td::brev32(v.z) : v.z;
        O = rev ? td::brev32(v.o) : v.o;
      }
      td::zo_prefix(Z, O);
      // lanes' word maps -> inclusive prefix across the warp
      uint32_t wz = __ballot_sync(0xFFFFFFFFu, (Z >> 31) & 1u);
      uint32_t wo = __ballot_sync(0xFFFFFFFFu, (O >> 31) & 1u);
      td::zo_prefix(wz, wo);
      if (lane == 31) {
        sh->wz[warp] = wz >> 31;
        sh->wo[warp] = wo >> 31;
      }
      __syncthreads();
      uint32_t* st = sh->state + (t & 1) * 33;
      if (warp == 0) {
        const uint32_t c = t == 0 ? 0u : sh->state[((t - 1) & 1) * 33 + nw];
        uint32_t xz = __ballot_sync(0xFFFFFFFFu, lane < nw ? sh->wz[lane] : 0u);
        uint32_t xo = __ballot_sync(0xFFFFFFFFu, lane < nw ? sh->wo[lane] : 1u);
        td::zo_prefix(xz, xo);
        if (lane == 0) st[0] = c;
        if (lane < nw) st[lane + 1] = ((c ? xo : xz) >> lane) & 1u;
      }
      __syncthreads();
      const uint32_t cw = st[warp];
      const uint32_t ct =
          lane == 0 ? cw : (((cw ? wo : wz) >> (lane - 1)) & 1u);
      if (i < C) {
        const uint32_t s = ct ? O : Z;
        out[w] = rev ? td::brev32(s) : s;
      }
    }
    __syncthreads();
#endif
  }
};

// Counts the passes of a derivation without touching memory.
struct CountOps {
  int C;
  int next;
  int passes;
  uint32_t dummy;
  TD_FN uint32_t* plane() { return &dummy; }
  template <class F>
  TD_FN void each(const F&) { ++passes; }
  template <class F>
  TD_FN void scan(uint32_t*, const F&, bool) { ++passes; }
};

__device__ GridOps window_ops(uint32_t* scratch, int N, Shared* sh) {
  const int S = gridDim.x, s = blockIdx.x, b = blockIdx.y;
  const int C = N / 32;
  return GridOps{scratch + (size_t)b * td::STARTS_PLANES * C, C, 0,
                 (int)((long long)s * C / S), (int)((long long)(s + 1) * C / S),
                 s, S, g_agg + (size_t)b * S, sh};
}

// char-major -> plane-major for the 32-word groups this block owns: for
// output words 32q..32q+31, lane j holds the char-major word of plane j;
// ballot t gathers bit t.
__device__ void store_plane_major(const uint32_t* S, int C, uint32_t* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = C / 32;
  const int q1 = (int)((long long)(blockIdx.x + 1) * groups / gridDim.x);
  uint32_t* ob = out + (size_t)blockIdx.y * C;
  for (int q = (int)((long long)blockIdx.x * groups / gridDim.x) + warp;
       q < q1; q += blockDim.x >> 5) {
    const uint32_t x = S[lane * groups + q];
    uint32_t mine = 0u;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const uint32_t bal = __ballot_sync(0xFFFFFFFFu, (x >> t) & 1u);
      if (lane == t) mine = bal;
    }
    ob[32 * q + lane] = mine;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
piece_starts_kernel(const uint8_t* data, const int32_t* nbytes, int N,
                    int profile, Lut lut, uint32_t* scratch, uint32_t* out) {
  __shared__ uint32_t s_lut[128];
  __shared__ Shared sh;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 128; i += blockDim.x) s_lut[i] = lut.v[i];
  __syncthreads();
  GridOps o = window_ops(scratch, N, &sh);
  const uint32_t* S = td::derive_window(o, data + (size_t)b * N, nbytes[b],
                                        s_lut, profile, N);
  store_plane_major(S, o.C, out);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
piece_starts_cp_kernel(const int32_t* cp, const int32_t* nchars, int N,
                       int profile, const uint16_t* table, uint32_t* scratch,
                       uint32_t* out) {
  __shared__ Shared sh;
  const int b = blockIdx.y;
  GridOps o = window_ops(scratch, N, &sh);
  const uint32_t* S = td::derive_window_cp(o, cp + (size_t)b * N, nchars[b],
                                           table, profile, N);
  store_plane_major(S, o.C, out);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
piece_starts_words_kernel(const int32_t* words, const int32_t* nchars, int N,
                          int profile, uint32_t* scratch, uint32_t* out) {
  __shared__ Shared sh;
  const int b = blockIdx.y;
  GridOps o = window_ops(scratch, N, &sh);
  const uint32_t* S = td::derive_window_words(o, words + (size_t)b * N,
                                              nchars[b], profile, N);
  store_plane_major(S, o.C, out);
}

// The kimi profile's window entries: the same with its Han rules
// (starts_derive.cuh han_prepass), kernels of their own so that the other
// profiles' kernels compile as they did without them.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
piece_starts_cp_kimi_kernel(const int32_t* cp, const int32_t* nchars, int N,
                            int profile, const uint16_t* table,
                            uint32_t* scratch, uint32_t* out) {
  __shared__ Shared sh;
  const int b = blockIdx.y;
  GridOps o = window_ops(scratch, N, &sh);
  const uint32_t* S = td::derive_window_cp<true>(
      o, cp + (size_t)b * N, nchars[b], table, profile, N);
  store_plane_major(S, o.C, out);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
piece_starts_words_kimi_kernel(const int32_t* words, const int32_t* nchars,
                               int N, int profile, uint32_t* scratch,
                               uint32_t* out) {
  __shared__ Shared sh;
  const int b = blockIdx.y;
  GridOps o = window_ops(scratch, N, &sh);
  const uint32_t* S = td::derive_window_words<true>(
      o, words + (size_t)b * N, nchars[b], profile, N);
  store_plane_major(S, o.C, out);
}

// Row entry: block b derives row b of codepoints in shared memory and
// writes its plane-major words with the any-C transpose.
__global__ void __launch_bounds__(kRowThreads)
piece_starts_row_kernel(const int32_t* cp, const int32_t* nchars, int N,
                        int profile, const uint16_t* table, uint32_t* out) {
  extern __shared__ uint32_t s_planes[];
  __shared__ Shared sh;
  const int b = blockIdx.x;
  const int C = N / 32;
  RowOps o{s_planes, C, 0, &sh};
  const uint32_t* S = td::derive_window_cp(o, cp + (size_t)b * N, nchars[b],
                                           table, profile, N);
  uint32_t* ob = out + (size_t)b * C;
  for (int w = threadIdx.x; w < C; w += blockDim.x)
    ob[w] = td::plane_major_word(S, C, w);
}

// The row entry under kimi.
__global__ void __launch_bounds__(kRowThreads)
piece_starts_row_kimi_kernel(const int32_t* cp, const int32_t* nchars, int N,
                             int profile, const uint16_t* table,
                             uint32_t* out) {
  extern __shared__ uint32_t s_planes[];
  __shared__ Shared sh;
  const int b = blockIdx.x;
  const int C = N / 32;
  RowOps o{s_planes, C, 0, &sh};
  const uint32_t* S = td::derive_window_cp<true>(o, cp + (size_t)b * N,
                                                 nchars[b], table, profile, N);
  uint32_t* ob = out + (size_t)b * C;
  for (int w = threadIdx.x; w < C; w += blockDim.x)
    ob[w] = td::plane_major_word(S, C, w);
}

// The blocks of `kernel` the card holds at once (at most kMaxBlocks).
template <class K>
cudaError_t resident_blocks(K kernel, int* cap) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                        kThreads, 0);
  *cap = sms * per < kMaxBlocks ? sms * per : kMaxBlocks;
  return err;
}

// A batch of B windows of N chars runs as groups of G windows, one
// cooperative launch each: G = B while B fits the card's co-resident
// blocks, else B split evenly into the fewest groups of at most `cap`.
// Each window of a group gets S = cap / G segments, at most one per word.
struct Groups {
  int G, S;
};

Groups groups(int cap, int B, int N) {
  const int n = B <= cap ? 1 : (B + cap - 1) / cap;
  const int G = (B + n - 1) / n;
  int S = G > 0 ? cap / G : 0;
  if (S > N / 32) S = N / 32;
  return Groups{G, S};
}

// Runs one(b0, G', S) for the groups of a batch in order, b0 the
// group's first window and G' its windows, on one stream: groups run one
// after another, so each may reuse the module-wide segment maps.
template <class K, class L>
int run_groups(K kernel, int B, int N, const L& one) {
  int cap = 0;
  cudaError_t err = resident_blocks(kernel, &cap);
  if (err != cudaSuccess) return (int)err;
  const Groups g = groups(cap, B, N);
  if (g.S < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  for (int b0 = 0; b0 < B; b0 += g.G) {
    err = one(b0, B - b0 < g.G ? B - b0 : g.G, g.S);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <class K, class... A>
cudaError_t launch(K kernel, int S, int G, cudaStream_t stream, A... args) {
  void* params[] = {(void*)&args...};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(S, G),
                                     dim3(kThreads), params, 0, stream);
}

}  // namespace

extern "C" {

// Scratch words the caller must provide per window.
long long td_piece_starts_scratch_words(int N) {
  return (long long)td::STARTS_PLANES * (N / 32);
}

// Passes over the window's planes one derivation makes (kimi: of general
// text, which has its Han rules; its ASCII windows make llama4's).
int td_piece_starts_passes(int profile, int N) {
  CountOps o{N / 32, 0, 0, 0u};
  if (profile == td::P_KIMI)
    td::derive_window_cp<true>(o, nullptr, 0, nullptr, profile, N);
  else
    td::derive_window(o, nullptr, 0, nullptr, profile, N);
  return o.passes;
}

// Blocks (segments) per window the launches of B windows of N chars use,
// for the entry td_piece_starts (0), td_piece_starts_cp (1) or
// td_piece_starts_words (2); 0 if the card cannot be read.
int td_piece_starts_blocks(int entry, int B, int N) {
  int cap = 0;
  const cudaError_t err =
      entry == 0   ? resident_blocks(piece_starts_kernel, &cap)
      : entry == 1 ? resident_blocks(piece_starts_cp_kernel, &cap)
                   : resident_blocks(piece_starts_words_kernel, &cap);
  return err == cudaSuccess ? groups(cap, B, N).S : 0;
}

// data (B, N) uint8, nbytes (B,) int32, lut 128 class words, scratch
// B * td_piece_starts_scratch_words(N) words, out (B, N/32) uint32.
// N must be a multiple of 1024. Launches on `stream` one at a time: the
// segment maps live in one module-wide buffer. kimi's ASCII windows have no
// Han: they run llama4's derivation over kimi's table (`lut`).
int td_piece_starts(const void* data, const void* nbytes, int B, int N,
                    int profile, const uint32_t* lut, void* scratch,
                    void* out, void* stream) {
  if (profile == td::P_KIMI) profile = td::P_LLAMA4;
  Lut l;
  for (int i = 0; i < 128; ++i) l.v[i] = lut[i];
  const size_t words = (size_t)td_piece_starts_scratch_words(N);
  return run_groups(piece_starts_kernel, B, N, [&](int b0, int G, int S) {
    return launch(piece_starts_kernel, S, G, (cudaStream_t)stream,
                  (const uint8_t*)data + (size_t)b0 * N,
                  (const int32_t*)nbytes + b0, N, profile, l,
                  (uint32_t*)scratch + b0 * words,
                  (uint32_t*)out + (size_t)b0 * (N / 32));
  });
}

// cp (B, N) int32 codepoints, nchars (B,) int32 valid lengths, table the
// (0x110000,) uint16 class words on the device, scratch and out as for
// td_piece_starts. N must be a multiple of 1024.
int td_piece_starts_cp(const void* cp, const void* nchars, int B, int N,
                       int profile, const void* table, void* scratch,
                       void* out, void* stream) {
  const size_t words = (size_t)td_piece_starts_scratch_words(N);
  const auto kernel = profile == td::P_KIMI ? piece_starts_cp_kimi_kernel
                                            : piece_starts_cp_kernel;
  return run_groups(kernel, B, N, [&](int b0, int G, int S) {
    return launch(kernel, S, G, (cudaStream_t)stream,
                  (const int32_t*)cp + (size_t)b0 * N,
                  (const int32_t*)nchars + b0, N, profile,
                  (const uint16_t*)table, (uint32_t*)scratch + b0 * words,
                  (uint32_t*)out + (size_t)b0 * (N / 32));
  });
}

// words (B, N) int32 class words per char (bits as char_class_words),
// nchars (B,) int32 valid lengths, scratch and out as for td_piece_starts.
// N must be a multiple of 1024.
int td_piece_starts_words(const void* words, const void* nchars, int B,
                          int N, int profile, void* scratch, void* out,
                          void* stream) {
  const size_t sw = (size_t)td_piece_starts_scratch_words(N);
  const auto kernel = profile == td::P_KIMI ? piece_starts_words_kimi_kernel
                                            : piece_starts_words_kernel;
  return run_groups(
      kernel, B, N, [&](int b0, int G, int S) {
        return launch(kernel, S, G, (cudaStream_t)stream,
                      (const int32_t*)words + (size_t)b0 * N,
                      (const int32_t*)nchars + b0, N, profile,
                      (uint32_t*)scratch + b0 * sw,
                      (uint32_t*)out + (size_t)b0 * (N / 32));
      });
}

// Row entry: cp (B, N) int32 codepoints, nchars (B,) int32 valid lengths,
// table as for td_piece_starts_cp, out (B, N/32) uint32 plane-major words.
// N must be a multiple of 32 and at most kRowMaxChars; one ordinary block
// per row, no scratch.
int td_piece_starts_cp_rows(const void* cp, const void* nchars, int B, int N,
                            int profile, const void* table, void* out,
                            void* stream) {
  if (N < 32 || N % 32 || N > kRowMaxChars || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int C = N / 32;
  const int threads = (C + 31) / 32 * 32;
  const size_t smem = (size_t)td::STARTS_PLANES * C * sizeof(uint32_t);
  const auto kernel = profile == td::P_KIMI ? piece_starts_row_kimi_kernel
                                            : piece_starts_row_kernel;
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cp, (const int32_t*)nchars, N, profile,
      (const uint16_t*)table, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
