// Host build of the K1 derivation (starts_derive.cuh).
//
// The CPU tests compile this with the system C++ compiler and hold its
// output against the plain torch version of ops/bitplane.py: it checks the
// transcription of the derivation that piece_starts.cu runs on the card,
// on a machine without one. SegOps runs a window as S segments one after
// another in the order the card's blocks combine them (each segment's map
// first, then each segment's carry-in composed from the maps before it in
// scan order, then its words), so the segmented scan is checked here too.
// Its output goes through the row entry's any-width transpose
// (plane_major_word), which rows of 256 chars need. The card-only
// parts of the kernel (the warp ballots, the barriers, shared memory and
// the ballot transpose) are checked on the card.
#include <stdint.h>

#include <vector>

#include "starts_derive.cuh"

namespace {

struct SegOps {
  uint32_t* scratch;
  int C;
  int next;
  int passes;
  int S;
  std::vector<uint32_t> agg;  // segment maps of a scan, by scan order

  // the scratch holds twice the planes the card's kernel may use, so an
  // overrun is reported (below) instead of corrupting memory
  uint32_t* plane() { return scratch + (size_t)(next++ % (2 * td::STARTS_PLANES)) * C; }

  int lo(int s) const { return (int)((long long)s * C / S); }

  template <class F>
  void each(const F& f) {
    ++passes;
    for (int s = 0; s < S; ++s)
      for (int w = lo(s); w < lo(s + 1); ++w) f(w);
  }

  // Sweeps segment s in scan order entering with the map (cz, co) and
  // returns the map after it (bit 0: z, bit 1: o); with `write` (cz == co)
  // out gets each word's states.
  template <class F>
  uint32_t segment(uint32_t* out, const F& f, bool rev, int s, uint32_t cz,
                   uint32_t co, bool write) {
    const int a = lo(s), e = lo(s + 1);
    for (int i = 0; i < e - a; ++i) {
      const int w = rev ? e - 1 - i : a + i;
      const td::ZO v = f(w);
      uint32_t Z = rev ? td::brev32(v.z) : v.z;
      uint32_t O = rev ? td::brev32(v.o) : v.o;
      td::zo_prefix(Z, O);
      if (write) {
        const uint32_t st = cz ? O : Z;
        out[w] = rev ? td::brev32(st) : st;
      }
      const uint32_t mz = Z >> 31, mo = O >> 31;
      const uint32_t nz = cz ? mo : mz, no = co ? mo : mz;
      cz = nz;
      co = no;
    }
    return cz | co << 1;
  }

  template <class F>
  void scan(uint32_t* out, const F& f, bool rev) {
    ++passes;
    agg.assign(S, 0u);
    for (int s = 0; s < S; ++s)
      agg[rev ? S - 1 - s : s] = segment(out, f, rev, s, 0u, 1u, false);
    for (int s = 0; s < S; ++s) {
      const int p = rev ? S - 1 - s : s;
      uint32_t c = 0u;
      for (int q = 0; q < p; ++q) c = c ? (agg[q] >> 1) & 1u : agg[q] & 1u;
      segment(out, f, rev, s, c, c, true);
    }
  }
};

// The row entry's transpose (any C), which equals the window entries'
// 32x32-bit ballot transpose wherever C % 32 == 0.
void store_plane_major(const uint32_t* St, int C, uint32_t* ob) {
  for (int wp = 0; wp < C; ++wp) ob[wp] = td::plane_major_word(St, C, wp);
}

// Runs derive(ops, b) for every window b with S segments; returns the
// number of passes of the last window, or -1 if the scratch planes ran out
// or S is not in [1, N/32].
template <class D>
int run_windows(int B, int N, int S, uint32_t* out, const D& derive) {
  const int C = N / 32;
  if (S < 1 || S > C) return -1;
  std::vector<uint32_t> scratch((size_t)2 * td::STARTS_PLANES * C);
  int passes = 0;
  for (int b = 0; b < B; ++b) {
    SegOps o{scratch.data(), C, 0, 0, S, {}};
    const uint32_t* St = derive(o, b);
    if (o.next > td::STARTS_PLANES) return -1;
    store_plane_major(St, C, out + (size_t)b * C);
    passes = o.passes;
  }
  return passes;
}

}  // namespace

extern "C" {

// Same contract as td_piece_starts (piece_starts.cu) on host memory, each
// window run as S segments; returns as run_windows.
int td_piece_starts_seg_host(const uint8_t* data, const int32_t* nbytes,
                             int B, int N, int profile, const uint32_t* lut,
                             int S, uint32_t* out) {
  return run_windows(B, N, S, out, [&](SegOps& o, int b) {
    return td::derive_window(o, data + (size_t)b * N, nbytes[b], lut,
                             profile, N);
  });
}

// Same contract as td_piece_starts_cp (piece_starts.cu) on host memory,
// each window run as S segments.
int td_piece_starts_cp_seg_host(const int32_t* cp, const int32_t* nchars,
                                int B, int N, int profile,
                                const uint16_t* table, int S, uint32_t* out) {
  return run_windows(B, N, S, out, [&](SegOps& o, int b) {
    return td::derive_window_cp(o, cp + (size_t)b * N, nchars[b], table,
                                profile, N);
  });
}

// Same contract as td_piece_starts_words (piece_starts.cu) on host memory,
// each window run as S segments.
int td_piece_starts_words_seg_host(const int32_t* words, const int32_t* nchars,
                                   int B, int N, int profile, int S,
                                   uint32_t* out) {
  return run_windows(B, N, S, out, [&](SegOps& o, int b) {
    return td::derive_window_words(o, words + (size_t)b * N, nchars[b],
                                   profile, N);
  });
}

}  // extern "C"
