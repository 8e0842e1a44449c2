// Host build of the K1 derivation (starts_derive.cuh), sequential.
//
// The CPU tests compile this with the system C++ compiler and hold its
// output against the plain torch version of ops/bitplane.py: it checks the
// transcription of the derivation that piece_starts.cu runs on the card,
// on a machine without one. The card-only parts of that kernel (the
// block-wide scan and the ballot transpose) are checked on the card.
#include <stdint.h>

#include <vector>

#include "starts_derive.cuh"

namespace {

struct SeqOps {
  uint32_t* scratch;
  int C;
  int next;
  int passes;

  // the scratch holds twice the planes the card's kernel may use, so an
  // overrun is reported (below) instead of corrupting memory
  uint32_t* plane() { return scratch + (size_t)(next++ % (2 * td::STARTS_PLANES)) * C; }

  template <class F>
  void each(const F& f) {
    ++passes;
    for (int w = 0; w < C; ++w) f(w);
  }

  template <class F>
  void scan(uint32_t* out, const F& f, bool rev) {
    ++passes;
    uint32_t c = 0u;
    for (int i = 0; i < C; ++i) {
      const int w = rev ? C - 1 - i : i;
      const td::ZO v = f(w);
      uint32_t Z = rev ? td::brev32(v.z) : v.z;
      uint32_t O = rev ? td::brev32(v.o) : v.o;
      td::zo_prefix(Z, O);
      const uint32_t s = c ? O : Z;
      c = s >> 31;
      out[w] = rev ? td::brev32(s) : s;
    }
  }
};


void store_plane_major(const uint32_t* S, int C, uint32_t* ob) {
  const int groups = C / 32;
  for (int wp = 0; wp < C; ++wp) {
    uint32_t v = 0u;
    for (int j = 0; j < 32; ++j) {
      const uint32_t x = S[j * groups + (wp >> 5)];
      v |= ((x >> (wp & 31)) & 1u) << j;
    }
    ob[wp] = v;
  }
}

}  // namespace

extern "C" {

// Same contract as td_piece_starts (piece_starts.cu) on host memory;
// returns the number of passes of the last window, or -1 if the scratch
// planes ran out.
int td_piece_starts_host(const uint8_t* data, const int32_t* nbytes, int B,
                         int N, int profile, const uint32_t* lut,
                         uint32_t* out) {
  const int C = N / 32;
  std::vector<uint32_t> scratch((size_t)2 * td::STARTS_PLANES * C);
  int passes = 0;
  for (int b = 0; b < B; ++b) {
    SeqOps o{scratch.data(), C, 0, 0};
    const uint32_t* S =
        td::derive_window(o, data + (size_t)b * N, nbytes[b], lut, profile, N);
    if (o.next > td::STARTS_PLANES) return -1;
    store_plane_major(S, C, out + (size_t)b * C);
    passes = o.passes;
  }
  return passes;
}

// Same contract as td_piece_starts_cp (piece_starts.cu) on host memory;
// returns as td_piece_starts_host.
int td_piece_starts_cp_host(const int32_t* cp, const int32_t* nchars, int B,
                            int N, int profile, const uint16_t* table,
                            uint32_t* out) {
  const int C = N / 32;
  std::vector<uint32_t> scratch((size_t)2 * td::STARTS_PLANES * C);
  int passes = 0;
  for (int b = 0; b < B; ++b) {
    SeqOps o{scratch.data(), C, 0, 0};
    const uint32_t* S = td::derive_window_cp(o, cp + (size_t)b * N,
                                             nchars[b], table, profile, N);
    if (o.next > td::STARTS_PLANES) return -1;
    store_plane_major(S, C, out + (size_t)b * C);
    passes = o.passes;
  }
  return passes;
}

// Same contract as td_piece_starts_words (piece_starts.cu) on host memory;
// returns as td_piece_starts_host.
int td_piece_starts_words_host(const int32_t* words, const int32_t* nchars,
                               int B, int N, int profile, uint32_t* out) {
  const int C = N / 32;
  std::vector<uint32_t> scratch((size_t)2 * td::STARTS_PLANES * C);
  int passes = 0;
  for (int b = 0; b < B; ++b) {
    SeqOps o{scratch.data(), C, 0, 0};
    const uint32_t* S = td::derive_window_words(o, words + (size_t)b * N,
                                                nchars[b], profile, N);
    if (o.next > td::STARTS_PLANES) return -1;
    store_plane_major(S, C, out + (size_t)b * C);
    passes = o.passes;
  }
  return passes;
}

}  // extern "C"
