// K1: piece starts, bytes or codepoints -> plane-major start words.
//
// Replaces the Pallas kernel of tokendagger_tpu/ops/bitplane.py:1152
// (piece_starts_bits_pallas, kernel `kern` at :1137-1159, packed_out=True)
// together with the XLA mask construction in front of it, which is folded
// in here. Two entries share the derivation (starts_derive.cuh):
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
// What bounds it on the H100: not bytes (a window reads 1 MB and writes
// 128 KB) but the ~95 dependent scans of the derivation, each a pass over
// the window's planes (128 KB per plane at 1 MB) with a block-wide carry.
// The TPU held all 12 class planes of a window in VMEM (~1.5 MB); an SM
// has 227 KB of shared memory, so here each window is one thread block of
// 1024 threads and its ~40 planes live in global memory, where the working
// set of 8 windows (~40 MB) stays in the 50 MB L2. Each scan is one pass:
// a thread composes its word's 32 1-bit maps in 5 shift steps, a warp
// composes its 32 words through two ballots, and a 32-entry shared array
// chains the warps and carries the state from one 1024-word tile to the
// next. Elementwise steps fuse their shifts and boolean algebra into one
// pass. Parallelism is the weak point: 8 windows keep 8 of 132 SMs busy.
//
// Output: word w' bit j = start flag of char j*C + w' (C = N/32), the
// reference's plane-major layout that compact.cu reads; the char-major
// result is transposed 32x32 bits at a time with ballots.
#include <cuda_runtime.h>
#include <stdint.h>

#include "starts_derive.cuh"

namespace {

constexpr int kThreads = 1024;

struct Lut {
  uint32_t v[128];
};

// Methods are __host__ __device__ so that the derivation templates, which
// are too, instantiate cleanly in both compilation passes; the bodies exist
// only in device code.
struct BlockOps {
  uint32_t* scratch;
  int C;
  int next;
  uint32_t* s_wz;     // [32] warp aggregates
  uint32_t* s_wo;
  uint32_t* s_state;  // [2][33] state entering each warp, double-buffered

  TD_FN uint32_t* plane() {
#ifdef __CUDA_ARCH__
    if (next >= td::STARTS_PLANES) __trap();
#endif
    return scratch + (size_t)(next++) * C;
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
      uint32_t Z = 0u, O = 0xFFFFFFFFu;  // identity beyond the window
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
        s_wz[warp] = wz >> 31;
        s_wo[warp] = wo >> 31;
      }
      __syncthreads();
      uint32_t* st = s_state + (t & 1) * 33;
      if (warp == 0) {
        const uint32_t c = t == 0 ? 0u : s_state[((t - 1) & 1) * 33 + nw];
        uint32_t xz = __ballot_sync(0xFFFFFFFFu, lane < nw ? s_wz[lane] : 0u);
        uint32_t xo = __ballot_sync(0xFFFFFFFFu, lane < nw ? s_wo[lane] : 1u);
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

// char-major -> plane-major: for 32 consecutive output words 32q..32q+31,
// lane j holds the char-major word of plane j; ballot t gathers bit t.
__device__ void store_plane_major(const uint32_t* S, int C, uint32_t* ob) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = C / 32;
  for (int q = warp; q < groups; q += blockDim.x >> 5) {
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

__global__ void __launch_bounds__(kThreads, 1)
piece_starts_kernel(const uint8_t* data, const int32_t* nbytes, int N,
                    int profile, Lut lut, uint32_t* scratch, uint32_t* out) {
  __shared__ uint32_t s_lut[128];
  __shared__ uint32_t s_wz[32], s_wo[32];
  __shared__ uint32_t s_state[2 * 33];
  const int b = blockIdx.x;
  const int C = N / 32;
  for (int i = threadIdx.x; i < 128; i += blockDim.x) s_lut[i] = lut.v[i];
  __syncthreads();
  BlockOps o{scratch + (size_t)b * td::STARTS_PLANES * C, C, 0,
             s_wz, s_wo, s_state};
  const uint32_t* S = td::derive_window(o, data + (size_t)b * N, nbytes[b],
                                        s_lut, profile, N);
  store_plane_major(S, C, out + (size_t)b * C);
}

__global__ void __launch_bounds__(kThreads, 1)
piece_starts_cp_kernel(const int32_t* cp, const int32_t* nchars, int N,
                       int profile, const uint16_t* table, uint32_t* scratch,
                       uint32_t* out) {
  __shared__ uint32_t s_wz[32], s_wo[32];
  __shared__ uint32_t s_state[2 * 33];
  const int b = blockIdx.x;
  const int C = N / 32;
  BlockOps o{scratch + (size_t)b * td::STARTS_PLANES * C, C, 0,
             s_wz, s_wo, s_state};
  const uint32_t* S = td::derive_window_cp(o, cp + (size_t)b * N, nchars[b],
                                           table, profile, N);
  store_plane_major(S, C, out + (size_t)b * C);
}

__global__ void __launch_bounds__(kThreads, 1)
piece_starts_words_kernel(const int32_t* words, const int32_t* nchars, int N,
                          int profile, uint32_t* scratch, uint32_t* out) {
  __shared__ uint32_t s_wz[32], s_wo[32];
  __shared__ uint32_t s_state[2 * 33];
  const int b = blockIdx.x;
  const int C = N / 32;
  BlockOps o{scratch + (size_t)b * td::STARTS_PLANES * C, C, 0,
             s_wz, s_wo, s_state};
  const uint32_t* S = td::derive_window_words(o, words + (size_t)b * N,
                                              nchars[b], profile, N);
  store_plane_major(S, C, out + (size_t)b * C);
}

}  // namespace

extern "C" {

// Scratch words the caller must provide per window.
long long td_piece_starts_scratch_words(int N) {
  return (long long)td::STARTS_PLANES * (N / 32);
}

// Passes over the window's planes one derivation makes.
int td_piece_starts_passes(int profile, int N) {
  CountOps o{N / 32, 0, 0, 0u};
  td::derive_window(o, nullptr, 0, nullptr, profile, N);
  return o.passes;
}

// data (B, N) uint8, nbytes (B,) int32, lut 128 class words, scratch
// B * td_piece_starts_scratch_words(N) words, out (B, N/32) uint32.
// N must be a multiple of 1024.
int td_piece_starts(const void* data, const void* nbytes, int B, int N,
                    int profile, const uint32_t* lut, void* scratch,
                    void* out, void* stream) {
  Lut l;
  for (int i = 0; i < 128; ++i) l.v[i] = lut[i];
  piece_starts_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)nbytes, N, profile, l,
      (uint32_t*)scratch, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// cp (B, N) int32 codepoints, nchars (B,) int32 valid lengths, table the
// (0x110000,) uint16 class words on the device, scratch and out as for
// td_piece_starts. N must be a multiple of 1024.
int td_piece_starts_cp(const void* cp, const void* nchars, int B, int N,
                       int profile, const void* table, void* scratch,
                       void* out, void* stream) {
  piece_starts_cp_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cp, (const int32_t*)nchars, N, profile,
      (const uint16_t*)table, (uint32_t*)scratch, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// words (B, N) int32 class words per char (bits as char_class_words),
// nchars (B,) int32 valid lengths, scratch and out as for td_piece_starts.
// N must be a multiple of 1024.
int td_piece_starts_words(const void* words, const void* nchars, int B,
                          int N, int profile, void* scratch, void* out,
                          void* stream) {
  piece_starts_words_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const int32_t*)nchars, N, profile,
      (uint32_t*)scratch, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
