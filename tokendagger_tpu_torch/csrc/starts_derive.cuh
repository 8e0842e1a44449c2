// Piece-start derivation over char-major bit planes.
//
// The word-space derivation of the JAX package's ops/bitplane.py
// (derive_starts_words, _derive_cl100k_words, _derive_gpt2_words), written
// once against an abstract "ops" backend so the same source runs
//   * on the card, one thread block per window (piece_starts.cu), and
//   * on the host, sequentially (piece_starts_host.cpp), which the CPU
//     tests build with the system C++ compiler to hold this transcription
//     against the plain torch version without a card.
//
// Layout: char-major. Word w of a plane holds chars 32w .. 32w+31, bit j =
// char 32w+j. A shift by k chars is a funnel shift of two neighbouring
// words, and every scan of the reference is a first-order recurrence along
// the char stream. All semantics are stated on that stream, exactly as in
// the reference, so the result is the same set of start flags; only the
// storage order differs from the reference's plane-major words.
//
// Backend interface (O):
//   int C;                          words per plane (chars / 32)
//   uint32_t* plane();              next scratch plane of C words
//   template <class F> void each(F f);      f(w) for every word, then a barrier
//   template <class F> void scan(uint32_t* out, F f, bool rev);
//       f(w) returns the word's 1-bit maps as ZO{z, o}: bit j of z (o) is
//       the state after char 32w+j when the state before it is 0 (1).
//       out[w] bit j = state after char 32w+j, scanning forward from
//       state 0 before char 0 (rev: backward from state 0 after the last
//       char; out then holds the state "after" in scan order).
// Every pass reads only planes written by earlier passes: no pass writes a
// plane it reads at another word.
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TD_FN __host__ __device__ __forceinline__
#define TD_UNROLL _Pragma("unroll")
#else
#define TD_FN inline
#define TD_UNROLL
#endif

namespace td {

// bits of the class words: the per-byte table (ops/bitplane.class_lut)
// and the per-codepoint table (unicode_tables.char_class_words)
enum : int {
  B_WS = 0, B_RN, B_LET, B_NUM, B_UC, B_LC, B_SP, B_APO, B_RNSL,
  B_G1,   // fold letters s t m d (gpt2: literal s d m t)
  B_GRV,  // fold letters r v
  B_GE,   // fold letter e
  B_GL,   // fold letter l
  N_LUT_BITS
};

enum : int { P_LLAMA4 = 0, P_NOCONTRACT = 1, P_CL100K = 2, P_GPT2 = 3 };

// scratch planes one window needs (checked by the backends)
constexpr int STARTS_PLANES = 48;

struct ZO {
  uint32_t z, o;
};

TD_FN uint32_t brev32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __brev(x);
#else
  x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
  x = ((x >> 2) & 0x33333333u) | ((x & 0x33333333u) << 2);
  x = ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);
  x = ((x >> 8) & 0x00FF00FFu) | ((x & 0x00FF00FFu) << 8);
  return (x >> 16) | (x << 16);
#endif
}

// In-word inclusive prefix of 1-bit maps (bit 0 first): afterwards bit j
// of (Z, O) is the map from the state before bit 0 to the state after
// bit j. Composition "earlier E, then M": z' = E.z ? M.o : M.z (and the
// same for o); the identity map (z=0, o=1) is shifted in.
TD_FN void zo_prefix(uint32_t& Z, uint32_t& O) {
  TD_UNROLL
  for (int k = 1; k < 32; k <<= 1) {
    const uint32_t ez = Z << k;
    const uint32_t eo = (O << k) | ((1u << k) - 1u);
    const uint32_t nz = (ez & O) | (~ez & Z);
    const uint32_t no = (eo & O) | (~eo & Z);
    Z = nz;
    O = no;
  }
}

// Plane reader.
struct Pl {
  const uint32_t* p;
  TD_FN uint32_t operator()(int u) const { return p[u]; }
};

// out[i] = f[i - k] over the char stream, 0 for i < k (prevk).
template <class F>
TD_FN uint32_t prvf(const F& f, int w, int k, int C) {
  const int q = k >> 5, r = k & 31;
  const int wh = w - q, wl = w - q - 1;
  const uint32_t hi = (wh >= 0 && wh < C) ? f(wh) : 0u;
  if (r == 0) return hi;
  const uint32_t lo = (wl >= 0 && wl < C) ? f(wl) : 0u;
  return (hi << r) | (lo >> (32 - r));
}

// out[i] = f[i + k] over the char stream, 0 past the end (nxtk).
template <class F>
TD_FN uint32_t nxf(const F& f, int w, int k, int C) {
  const int q = k >> 5, r = k & 31;
  const int wl = w + q, wh = w + q + 1;
  const uint32_t lo = (wl >= 0 && wl < C) ? f(wl) : 0u;
  if (r == 0) return lo;
  const uint32_t hi = (wh >= 0 && wh < C) ? f(wh) : 0u;
  return (lo >> r) | (hi << (32 - r));
}

template <class O, class F>
TD_FN void ew(O& o, uint32_t* out, const F& f) {
  o.each([&](int w) { out[w] = f(w); });
}

// s[i] = (s[i-1] & a[i]) | b[i], s[-1] = 0   (_affine_fwd)
template <class O, class FA, class FB>
TD_FN void affine_fwd(O& o, uint32_t* out, const FA& fa, const FB& fb) {
  o.scan(out, [&](int w) {
    const uint32_t a = fa(w), b = fb(w);
    return ZO{b, a | b};
  }, false);
}

// s[i] = (s[i+1] & a[i]) | b[i], s[N] = 0   (_affine_rev)
template <class O, class FA, class FB>
TD_FN void affine_rev(O& o, uint32_t* out, const FA& fa, const FB& fb) {
  o.scan(out, [&](int w) {
    const uint32_t a = fa(w), b = fb(w);
    return ZO{b, a | b};
  }, true);
}

// inclusive prefix XOR   (xor_scan_fwd)
template <class O, class FX>
TD_FN void xor_fwd(O& o, uint32_t* out, const FX& fx) {
  o.scan(out, [&](int w) {
    const uint32_t x = fx(w);
    return ZO{x, ~x};
  }, false);
}

TD_FN uint32_t valid_word(int w, int m) {
  const long long t = (long long)m - 32LL * w;
  if (t >= 32) return 0xFFFFFFFFu;
  if (t <= 0) return 0u;
  return (1u << (uint32_t)t) - 1u;
}

// The class planes of one window.
struct Masks {
  uint32_t* valid;
  uint32_t* bit[N_LUT_BITS];
};

// Mask construction (_char_masks_planes): bytes at or beyond m belong to
// no class; a valid byte's classes come from lut[byte & 0x7F], as the
// reference builds them from the 7 low bit-planes.
template <class O>
TD_FN Masks build_masks(O& o, const uint8_t* data, int m,
                        const uint32_t* lut) {
  Masks M;
  M.valid = o.plane();
  for (int i = 0; i < N_LUT_BITS; ++i) M.bit[i] = o.plane();
  o.each([&](int w) {
    uint32_t acc[N_LUT_BITS];
    for (int i = 0; i < N_LUT_BITS; ++i) acc[i] = 0u;
    const uint32_t* d4 = reinterpret_cast<const uint32_t*>(data) + 8 * w;
    for (int q = 0; q < 8; ++q) {
      const uint32_t four = d4[q];
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * q + k;
        const uint32_t cls =
            (32 * w + j < m) ? lut[(four >> (8 * k)) & 0x7Fu] : 0u;
        for (int i = 0; i < N_LUT_BITS; ++i)
          acc[i] |= ((cls >> i) & 1u) << j;
      }
    }
    for (int i = 0; i < N_LUT_BITS; ++i) M.bit[i][w] = acc[i];
    M.valid[w] = valid_word(w, m);
  });
  return M;
}

// Mask construction for general text (_char_masks): chars at or beyond m
// belong to no class; a valid char i has the class word cls(i).
template <class O, class F>
TD_FN Masks build_masks_from(O& o, int m, const F& cls) {
  Masks M;
  M.valid = o.plane();
  for (int i = 0; i < N_LUT_BITS; ++i) M.bit[i] = o.plane();
  o.each([&](int w) {
    uint32_t acc[N_LUT_BITS];
    for (int i = 0; i < N_LUT_BITS; ++i) acc[i] = 0u;
    for (int j = 0; j < 32 && 32 * w + j < m; ++j) {
      const uint32_t c = cls(32 * w + j);
      for (int i = 0; i < N_LUT_BITS; ++i) acc[i] |= ((c >> i) & 1u) << j;
    }
    for (int i = 0; i < N_LUT_BITS; ++i) M.bit[i][w] = acc[i];
    M.valid[w] = valid_word(w, m);
  });
  return M;
}

// Class words from codepoints: table[cp[i]] of the per-codepoint table; a
// codepoint outside [0, 0x10FFFF] has none.
struct CpClass {
  const int32_t* cp;
  const uint16_t* table;
  TD_FN uint32_t operator()(int i) const {
    const uint32_t v = (uint32_t)cp[i];
    return v < 0x110000u ? (uint32_t)table[v] : 0u;
  }
};

// Class words given per char (the hot-codepoint class lookup's output).
struct WordClass {
  const int32_t* words;
  TD_FN uint32_t operator()(int i) const { return (uint32_t)words[i]; }
};

// stride_marks(seed, carrier, 3, n): positions reachable from a seed by
// +3 steps whose spans lie in the carrier; log-doubling as the reference.
template <class O, class FS, class FC>
TD_FN uint32_t* stride3_marks(O& o, const FS& seed, const FC& carrier,
                              int n) {
  const int C = o.C;
  uint32_t* oa = o.plane();
  uint32_t* ob = o.plane();
  uint32_t* sa = o.plane();
  uint32_t* sb = o.plane();
  o.each([&](int w) {
    oa[w] = seed(w);
    sa[w] = carrier(w) & prvf(carrier, w, 1, C) & prvf(carrier, w, 2, C);
  });
  for (int step = 3; step < n; step *= 2) {
    const Pl OA{oa}, SA{sa};
    uint32_t* nob = ob;
    uint32_t* nsb = sb;
    o.each([&](int w) {
      nob[w] = OA(w) | (prvf(OA, w, step, C) & SA(w));
      nsb[w] = SA(w) & prvf(SA, w, step, C);
    });
    ob = oa;
    oa = nob;
    sb = sa;
    sa = nsb;
  }
  return oa;
}

// ---------------------------------------------------------------------------
// o200k family (llama4, nocontract): derive_starts_words
// ---------------------------------------------------------------------------
template <class O>
TD_FN void derive_o200k(O& o, const Masks& M, bool contractions, int n_total,
                        uint32_t* out) {
  const int C = o.C;
  const Pl valid{M.valid}, ws{M.bit[B_WS]}, rn{M.bit[B_RN]},
      let{M.bit[B_LET]}, num{M.bit[B_NUM]}, uc{M.bit[B_UC]},
      lc{M.bit[B_LC]}, sp{M.bit[B_SP]}, apo{M.bit[B_APO]},
      rnsl{M.bit[B_RNSL]}, g1{M.bit[B_G1]}, grv{M.bit[B_GRV]},
      ge{M.bit[B_GE]}, gl{M.bit[B_GL]};
  auto P1 = [&](const auto& f, int u) { return prvf(f, u, 1, C); };
  auto N1 = [&](const auto& f, int u) { return nxf(f, u, 1, C); };
  auto ZERO = [](int) { return 0u; };
  auto ALL1 = [](int) { return 0xFFFFFFFFu; };
  auto AT0 = [](int u) { return u == 0 ? 1u : 0u; };

  auto WD = [&](int u) { return uc(u) | lc(u); };
  auto PU_RE = [&](int u) { return ~(ws(u) | let(u) | num(u)) & valid(u); };
  auto MARK = [&](int u) { return PU_RE(u) & WD(u); };
  auto U_ = [&](int u) { return uc(u) & ~lc(u); };
  auto L_ = [&](int u) { return lc(u) & ~uc(u); };
  auto O_ = [&](int u) { return uc(u) & lc(u); };
  auto FOLD1 = [&](int u) { return nxf(g1, u, 1, C); };
  auto FOLD2 = [&](int u) {
    return (nxf(grv, u, 1, C) & nxf(ge, u, 2, C)) |
           (nxf(gl, u, 1, C) & nxf(gl, u, 2, C));
  };

  // region partition: newreg[i] = class(i) != class(i-1), set at 0
  uint32_t* newreg = o.plane();
  {
    auto K1 = [&](int u) { return num(u) & ~ws(u); };
    auto K2 = [&](int u) { return WD(u) & ~ws(u) & ~num(u); };
    auto K3 = [&](int u) { return valid(u) & ~ws(u) & ~num(u) & ~WD(u); };
    auto K4 = [&](int u) { return ~valid(u); };
    ew(o, newreg, [&](int w) {
      const uint32_t same = (ws(w) & P1(ws, w)) | (K1(w) & P1(K1, w)) |
                            (K2(w) & P1(K2, w)) | (K3(w) & P1(K3, w)) |
                            (K4(w) & P1(K4, w));
      return ~same;
    });
  }
  const Pl NEWREG{newreg};

  uint32_t* ct2 = o.plane();
  uint32_t* ct3 = o.plane();
  uint32_t* pux = o.plane();
  uint32_t* absorbed = o.plane();
  uint32_t* cov = o.plane();
  uint32_t* eqc = o.plane();
  uint32_t* bi0 = o.plane();
  uint32_t* bws = o.plane();
  uint32_t* bnd = o.plane();
  uint32_t* flow = o.plane();
  uint32_t* t_a = o.plane();
  uint32_t* t_b = o.plane();
  uint32_t* t_c = o.plane();
  uint32_t* rej = o.plane();
  const Pl CT2{ct2}, CT3{ct3}, PUX{pux}, ABS{absorbed}, COV{cov}, EQC{eqc},
      BI0{bi0}, BWS{bws}, BND{bnd}, FLOW{flow}, TA{t_a}, TB{t_b}, TC{t_c},
      REJ{rej};
  ew(o, ct2, ZERO);
  ew(o, ct3, ZERO);

  auto PURC = [&](int u) { return PUX(u) | MARK(u); };
  auto BAD = [&](int u) { return PUX(u) & ~N1(MARK, u); };

  // ws_rules_b: writes bound_into (and b_ws when wanted)
  auto ws_rules = [&](uint32_t* b_ws_out, uint32_t* bound_out) {
    auto X = [&](int u) { return rn(u) & ~ABS(u); };
    // e_x = seg_or_rev(x, newreg)
    affine_rev(o, t_a, [&](int w) { return ~N1(NEWREG, w); }, X);
    const Pl EX = TA;
    auto EXISTS_LATER = [&](int u) { return N1(EX, u) & ~N1(NEWREG, u); };
    auto IS_LAST_RN = [&](int u) { return X(u) & ~EXISTS_LATER(u); };
    auto IN_TAIL = [&](int u) { return ws(u) & ~rn(u) & ~ABS(u) & ~EX(u); };
    auto NRV = [&](int u) { return NEWREG(u) & valid(u); };
    auto AT_LAST = [&](int u) { return IN_TAIL(u) & N1(NRV, u); };
    auto ELIGIBLE = [&](int u) {
      return AT_LAST(u) & ((N1(WD, u) & ~rn(u)) | (sp(u) & N1(PU_RE, u)));
    };
    ew(o, bound_out, [&](int w) { return P1(ELIGIBLE, w); });
    if (b_ws_out) {
      auto NOTWS = [&](int u) { return ~ws(u); };
      ew(o, b_ws_out, [&](int w) {
        const uint32_t ws_entry =
            ws(w) & ~ABS(w) & (P1(NOTWS, w) | P1(ABS, w) | AT0(w));
        const uint32_t b_after_rn = ws(w) & P1(IS_LAST_RN, w);
        const uint32_t b_ws_split = AT_LAST(w) & P1(IN_TAIL, w);
        return (ws_entry | b_after_rn | b_ws_split) & ws(w);
      });
    }
  };

  // a4_cover_b into cov (and eqc when wanted)
  auto a4_cover = [&](const auto& BI, bool want_eq) {
    auto RUN_START = [&](int u) { return PURC(u) & ~P1(PURC, u); };
    auto ENTRY = [&](int u) {
      return PURC(u) & (RUN_START(u) | (~ABS(u) & P1(ABS, u)));
    };
    auto START_COVER = [&](int u) { return PUX(u) & BI(u) & RUN_START(u); };
    // sc_fill = ffill_bool(entry, start_cover)
    affine_fwd(o, t_a,
               [&](int w) { return ~(ENTRY(w) & ~START_COVER(w)); },
               [&](int w) { return ENTRY(w) & START_COVER(w); });
    // bad_since = seg_or_fwd(bad, entry)
    affine_fwd(o, t_b, [&](int w) { return ~ENTRY(w); }, BAD);
    // hasentry = or_scan_fwd(entry)
    affine_fwd(o, t_c, ALL1, ENTRY);
    const Pl SCF = TA, BSN = TB, HAS = TC;
    ew(o, cov, [&](int w) { return PURC(w) & HAS(w) & (SCF(w) | BSN(w)); });
    if (want_eq) {
      ew(o, eqc, [&](int w) {
        const uint32_t e = ENTRY(w);
        const uint32_t first_bad_since = BAD(w) & (e | ~P1(BSN, w));
        return (e & START_COVER(w)) | (HAS(w) & ~SCF(w) & first_bad_since);
      });
    }
  };

  // absorption_b(a4_covered, purc) into absorbed
  auto absorption = [&]() {
    auto CP = [&](int u) { return COV(u) & PURC(u); };
    // seg_or_fwd(t0, ~rnsl): a = ~~rnsl
    affine_fwd(o, t_a, rnsl, [&](int w) { return rn(w) & P1(CP, w); });
    ew(o, absorbed, [&](int w) { return rnsl(w) & TA(w); });
  };

  const int n_rounds = contractions ? 2 : 1;
  for (int round = 0; round < n_rounds; ++round) {
    ew(o, pux, [&](int w) {
      return PU_RE(w) & ~WD(w) & ~(CT2(w) | CT3(w));
    });
    ew(o, absorbed, ZERO);
    for (int it = 0; it < 4; ++it) {
      a4_cover(ZERO, false);
      absorption();
    }
    ws_rules(nullptr, bi0);
    for (int it = 0; it < 4; ++it) {
      a4_cover(BI0, it == 3);
      absorption();
    }
    // flow_marks = mark & ffill_bool(~mark, a4_covered & PUx & ~absorbed)
    {
      auto FX = [&](int u) { return COV(u) & PUX(u) & ~ABS(u); };
      affine_fwd(o, t_a, [&](int w) { return ~(~MARK(w) & ~FX(w)); },
                 [&](int w) { return ~MARK(w) & FX(w); });
      ew(o, flow, [&](int w) { return MARK(w) & TA(w); });
    }
    ws_rules(bws, bnd);
    if (!contractions) break;

    // contraction absorption
    auto WEC = [&](int u) {
      const uint32_t mk = MARK(u);
      return (WD(u) & ~mk) | (mk & ~(FLOW(u) | (COV(u) & mk)));
    };
    ew(o, ct2, [&](int w) { return apo(w) & P1(WEC, w) & FOLD1(w); });
    ew(o, ct3, [&](int w) {
      return apo(w) & P1(WEC, w) & FOLD2(w) & ~FOLD1(w);
    });
    auto CAND = [&](int u) { return CT2(u) | CT3(u); };
    auto C2E = [&](int u) { return CT2(u) & ~nxf(WD, u, 2, C); };
    auto C3E = [&](int u) { return CT3(u) & ~nxf(WD, u, 3, C); };
    auto LINK_IN = [&](int u) {
      const uint32_t pc = P1(CAND, u);
      return CAND(u) & ((prvf(C2E, u, 2, C) & ~pc) |
                        (prvf(C3E, u, 3, C) & ~pc & ~prvf(CAND, u, 2, C)));
    };
    xor_fwd(o, t_a, CAND);  // par
    const Pl PAR = TA;
    auto CHAIN_START = [&](int u) { return CAND(u) & ~LINK_IN(u); };
    // par_at_start = ffill_bool(chain_start, par)
    affine_fwd(o, t_b, [&](int w) { return ~(CHAIN_START(w) & ~PAR(w)); },
               [&](int w) { return CHAIN_START(w) & PAR(w); });
    const Pl PAS = TB;
    ew(o, rej, [&](int w) { return CAND(w) & (PAR(w) ^ PAS(w)); });
    ew(o, ct2, [&](int w) { return CT2(w) & ~REJ(w); });
    ew(o, ct3, [&](int w) { return CT3(w) & ~REJ(w); });
  }

  // ---- after the rounds: pux is the last round's PUx (purc_loop) ----
  auto PURC_LOOP = PURC;
  auto CT_ANY = [&](int u) { return CT2(u) | CT3(u); };
  uint32_t* al = o.plane();
  uint32_t* fe = o.plane();
  const Pl AL{al}, FE{fe};
  ew(o, al, [&](int w) {
    return P1(CT2, w) | P1(CT3, w) | prvf(CT3, w, 2, C);
  });
  ew(o, fe, [&](int w) {
    return WD(w) & (prvf(CT2, w, 2, C) | prvf(CT3, w, 3, C)) & ~AL(w);
  });

  auto NUM_SEED = [&](int u) { return num(u) & NEWREG(u); };
  const Pl BNUM_RAW{stride3_marks(o, NUM_SEED, num, n_total)};

  uint32_t* lau = o.plane();
  uint32_t* sor = o.plane();
  uint32_t* wamt = o.plane();
  const Pl LAU{lau}, SOR{sor}, WAMT{wamt};
  // l_after_u = seg_or_fwd(L & ~AL, U | brk_w), brk_w = ~wd | AL
  affine_fwd(o, lau, [&](int w) { return ~(U_(w) | ~WD(w) | AL(w)); },
             [&](int w) { return L_(w) & ~AL(w); });
  // seg_or_rev(O | L, ~wd)
  auto NOTWD = [&](int u) { return ~WD(u); };
  affine_rev(o, sor, [&](int w) { return ~N1(NOTWD, w); },
             [&](int w) { return O_(w) | L_(w); });
  // ffill_bool(~mark, wd & ~mark)
  affine_fwd(o, wamt,
             [&](int w) { return ~(~MARK(w) & ~(WD(w) & ~MARK(w))); },
             [&](int w) { return ~MARK(w) & (WD(w) & ~MARK(w)); });

  auto R1 = [&](int u) { return U_(u) & P1(LAU, u); };
  auto R2 = [&](int u) { return U_(u) & P1(O_, u) & ~SOR(u) & ~R1(u); };
  auto B_WD = [&](int u) {
    const uint32_t b = (R1(u) | R2(u) | FE(u)) & ~AL(u) & ~FLOW(u);
    return b | (WD(u) & ~MARK(u) & P1(FLOW, u));
  };
  auto PUX_F = [&](int u) { return PU_RE(u) & ~WD(u) & ~CT_ANY(u); };
  auto PURC_F = [&](int u) { return PUX_F(u) | MARK(u); };
  auto B_PU = [&](int u) {
    const uint32_t in_run_past_start = PURC_LOOP(u) & P1(PURC_LOOP, u);
    const uint32_t pur_alt = PUX_F(u) & P1(MARK, u) & in_run_past_start &
                             (~COV(u) | EQC(u));
    return pur_alt & ~ABS(u);
  };
  auto RUN_START_LOOP = [&](int u) {
    return PURC_LOOP(u) & ~P1(PURC_LOOP, u);
  };

  uint32_t* base = o.plane();
  uint32_t* sup = o.plane();
  const Pl BASE{base}, SUP{sup};
  ew(o, base, [&](int w) {
    const uint32_t pf = PURC_F(w);
    uint32_t b = BWS(w) | (num(w) & BNUM_RAW(w)) | B_WD(w) | B_PU(w);
    b |= NEWREG(w) & ~ws(w) & ~pf & valid(w);
    b |= pf & RUN_START_LOOP(w);
    b |= pf & ~ABS(w) & P1(ABS, w);
    return b;
  });
  ew(o, sup, [&](int w) {
    const uint32_t s = ABS(w) | FLOW(w) | AL(w) | BND(w) | CT_ANY(w);
    const uint32_t wam = MARK(w) & WAMT(w);
    return s | (wam & ~FE(w));
  });
  auto PB_SRC = [&](int u) {
    const uint32_t b = BASE(u), ns = b & ~SUP(u);
    const uint32_t base_start = (ws(u) & ns) | (~ws(u) & num(u) & b) |
                                (~ws(u) & ~num(u) & PURC_F(u) & ~WD(u) & ns);
    const uint32_t p1 = ~(rn(u) | let(u) | num(u)) & valid(u);
    return base_start & p1 & ~WD(u) & ~AL(u);
  };
  ew(o, out, [&](int w) {
    const uint32_t prefix_bind = WD(w) & P1(PB_SRC, w);
    const uint32_t st = BASE(w) & ~(SUP(w) | prefix_bind) & valid(w);
    const uint32_t a0 = AT0(w);
    return (st & ~a0) | (valid(w) & a0);
  });
}

// ---------------------------------------------------------------------------
// gpt2: _derive_gpt2_words (fold planes carry the case-sensitive letters)
// ---------------------------------------------------------------------------
template <class O>
TD_FN void derive_gpt2(O& o, const Masks& M, uint32_t* out) {
  const int C = o.C;
  const Pl valid{M.valid}, ws{M.bit[B_WS]}, let{M.bit[B_LET]},
      num{M.bit[B_NUM]}, sp{M.bit[B_SP]}, apo{M.bit[B_APO]},
      g1{M.bit[B_G1]}, grv{M.bit[B_GRV]}, ge{M.bit[B_GE]}, gl{M.bit[B_GL]};
  auto P1 = [&](const auto& f, int u) { return prvf(f, u, 1, C); };
  auto N1 = [&](const auto& f, int u) { return nxf(f, u, 1, C); };
  auto AT0 = [](int u) { return u == 0 ? 1u : 0u; };
  auto FOLD1 = [&](int u) { return nxf(g1, u, 1, C); };
  auto FOLD2 = [&](int u) {
    return (nxf(grv, u, 1, C) & nxf(ge, u, 2, C)) |
           (nxf(gl, u, 1, C) & nxf(gl, u, 2, C));
  };
  auto PU = [&](int u) { return ~(ws(u) | let(u) | num(u)) & valid(u); };
  auto INV = [&](int u) { return ~valid(u); };

  uint32_t* newreg = o.plane();
  ew(o, newreg, [&](int w) {
    const uint32_t same = (ws(w) & P1(ws, w)) | (let(w) & P1(let, w)) |
                          (num(w) & P1(num, w)) | (PU(w) & P1(PU, w)) |
                          (INV(w) & P1(INV, w));
    return ~same;
  });
  const Pl NEWREG{newreg};
  auto VNW = [&](int u) { return valid(u) & ~ws(u); };
  auto LAST_WS_MID = [&](int u) { return ws(u) & N1(VNW, u); };
  auto BIND_WS = [&](int u) { return LAST_WS_MID(u) & sp(u); };
  auto CT_OK = [&](int u) {
    return apo(u) & PU(u) & NEWREG(u) & ~P1(BIND_WS, u);
  };
  uint32_t* ct2 = o.plane();
  uint32_t* ct3 = o.plane();
  const Pl CT2{ct2}, CT3{ct3};
  ew(o, ct2, [&](int w) { return CT_OK(w) & FOLD1(w); });
  ew(o, ct3, [&](int w) { return CT_OK(w) & FOLD2(w) & ~FOLD1(w); });
  ew(o, out, [&](int w) {
    const uint32_t al = P1(CT2, w) | P1(CT3, w) | prvf(CT3, w, 2, C);
    const uint32_t fe = let(w) & (prvf(CT2, w, 2, C) | prvf(CT3, w, 3, C));
    const uint32_t b_ws =
        (ws(w) & NEWREG(w)) | (LAST_WS_MID(w) & P1(ws, w));
    const uint32_t base = b_ws | (NEWREG(w) & ~ws(w) & valid(w)) | fe;
    const uint32_t sup = (P1(BIND_WS, w) & ~ws(w)) | al;
    const uint32_t st = base & ~sup & valid(w);
    const uint32_t a0 = AT0(w);
    return (st & ~a0) | (valid(w) & a0);
  });
}

// ---------------------------------------------------------------------------
// cl100k: _derive_cl100k_words
// ---------------------------------------------------------------------------
template <class O>
TD_FN void derive_cl100k(O& o, const Masks& M, int n_total, uint32_t* out) {
  const int C = o.C;
  const Pl valid{M.valid}, ws{M.bit[B_WS]}, rn{M.bit[B_RN]},
      let{M.bit[B_LET]}, num{M.bit[B_NUM]}, sp{M.bit[B_SP]},
      apo{M.bit[B_APO]}, g1{M.bit[B_G1]}, grv{M.bit[B_GRV]},
      ge{M.bit[B_GE]}, gl{M.bit[B_GL]};
  auto P1 = [&](const auto& f, int u) { return prvf(f, u, 1, C); };
  auto N1 = [&](const auto& f, int u) { return nxf(f, u, 1, C); };
  auto AT0 = [](int u) { return u == 0 ? 1u : 0u; };
  auto FOLD1 = [&](int u) { return nxf(g1, u, 1, C); };
  auto FOLD2 = [&](int u) {
    return (nxf(grv, u, 1, C) & nxf(ge, u, 2, C)) |
           (nxf(gl, u, 1, C) & nxf(gl, u, 2, C));
  };
  auto PU = [&](int u) { return ~(ws(u) | let(u) | num(u)) & valid(u); };
  auto INV = [&](int u) { return ~valid(u); };

  uint32_t* newreg = o.plane();
  ew(o, newreg, [&](int w) {
    const uint32_t same = (ws(w) & P1(ws, w)) | (let(w) & P1(let, w)) |
                          (num(w) & P1(num, w)) | (PU(w) & P1(PU, w)) |
                          (INV(w) & P1(INV, w));
    return ~same;
  });
  const Pl NEWREG{newreg};
  auto NUM_SEED = [&](int u) { return num(u) & NEWREG(u); };
  const Pl BNUM_RAW{stride3_marks(o, NUM_SEED, num, n_total)};

  // [\r\n]* tail absorption: rn-runs directly after punct
  uint32_t* t_a = o.plane();
  uint32_t* absorbed = o.plane();
  const Pl TA{t_a}, ABS{absorbed};
  affine_fwd(o, t_a, rn, [&](int w) {
    return rn(w) & ~P1(rn, w) & P1(PU, w);
  });
  ew(o, absorbed, [&](int w) { return rn(w) & TA(w); });

  auto X = [&](int u) { return rn(u) & ~ABS(u); };
  uint32_t* ex = o.plane();
  const Pl EX{ex};
  affine_rev(o, ex, [&](int w) { return ~N1(NEWREG, w); }, X);
  auto IS_LAST_RN = [&](int u) {
    return X(u) & ~(N1(EX, u) & ~N1(NEWREG, u));
  };
  auto IN_TAIL = [&](int u) { return ws(u) & ~rn(u) & ~ABS(u) & ~EX(u); };
  auto NRV = [&](int u) { return NEWREG(u) & valid(u); };
  auto AT_LAST = [&](int u) { return IN_TAIL(u) & N1(NRV, u); };
  auto ELIGIBLE = [&](int u) {
    return AT_LAST(u) & (N1(let, u) | (sp(u) & N1(PU, u)));
  };
  uint32_t* bnd = o.plane();
  const Pl BND{bnd};
  ew(o, bnd, [&](int w) { return P1(ELIGIBLE, w); });

  auto PU_START = [&](int u) { return PU(u) & NEWREG(u); };
  auto CT_OK = [&](int u) { return apo(u) & PU_START(u) & ~BND(u); };
  uint32_t* ct2 = o.plane();
  uint32_t* ct3 = o.plane();
  const Pl CT2{ct2}, CT3{ct3};
  ew(o, ct2, [&](int w) { return CT_OK(w) & FOLD1(w); });
  ew(o, ct3, [&](int w) { return CT_OK(w) & FOLD2(w) & ~FOLD1(w); });
  auto CT_ANY = [&](int u) { return CT2(u) | CT3(u); };
  auto BIND_PU = [&](int u) {
    return PU_START(u) & ~BND(u) & ~CT_ANY(u) & N1(let, u);
  };
  auto NOTWS = [&](int u) { return ~ws(u); };
  ew(o, out, [&](int w) {
    const uint32_t ws_entry =
        ws(w) & ~ABS(w) & (P1(NOTWS, w) | P1(ABS, w) | AT0(w));
    const uint32_t b_after_rn = ws(w) & P1(IS_LAST_RN, w);
    const uint32_t b_ws_split = AT_LAST(w) & P1(IN_TAIL, w);
    const uint32_t b_ws = ws_entry | b_after_rn | b_ws_split;
    const uint32_t al = P1(CT2, w) | P1(CT3, w) | prvf(CT3, w, 2, C);
    const uint32_t fe =
        let(w) & (prvf(CT2, w, 2, C) | prvf(CT3, w, 3, C)) & ~al;
    const uint32_t base = b_ws | (num(w) & BNUM_RAW(w)) |
                          (NEWREG(w) & (let(w) | PU(w))) | fe;
    const uint32_t sup = ABS(w) | al | BND(w) | P1(BIND_PU, w);
    const uint32_t st = base & ~sup & valid(w);
    const uint32_t a0 = AT0(w);
    return (st & ~a0) | (valid(w) & a0);
  });
}

// Class planes -> char-major start words (returned plane).
template <class O>
TD_FN uint32_t* derive_masks(O& o, const Masks& M, int profile, int n) {
  uint32_t* out = o.plane();
  if (profile == P_GPT2) {
    derive_gpt2(o, M, out);
  } else if (profile == P_CL100K) {
    derive_cl100k(o, M, n, out);
  } else {
    derive_o200k(o, M, profile == P_LLAMA4, n, out);
  }
  return out;
}

// Whole ASCII window: bytes -> char-major start words.
template <class O>
TD_FN uint32_t* derive_window(O& o, const uint8_t* data, int m,
                              const uint32_t* lut, int profile, int n) {
  return derive_masks(o, build_masks(o, data, m, lut), profile, n);
}

// Whole window of codepoints (general text) -> char-major start words.
template <class O>
TD_FN uint32_t* derive_window_cp(O& o, const int32_t* cp, int m,
                                 const uint16_t* table, int profile, int n) {
  return derive_masks(o, build_masks_from(o, m, CpClass{cp, table}),
                      profile, n);
}

// Whole window of per-char class words -> char-major start words.
template <class O>
TD_FN uint32_t* derive_window_words(O& o, const int32_t* words, int m,
                                    int profile, int n) {
  return derive_masks(o, build_masks_from(o, m, WordClass{words}), profile,
                      n);
}

}  // namespace td
