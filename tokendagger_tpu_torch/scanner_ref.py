r"""Vectorized pretokenizer scanner — numpy reference implementation.

Replaces the reference's backtracking PCRE2 engine
(src/tiktoken/tiktoken.cpp:70-128) with a data-parallel
formulation tailored to the tiktoken pattern family (Llama-4 pattern at
src/main.cpp:114; Mistral Tekken uses the same pattern minus
the contraction alternates):

    A1  [^\r\n\p{L}\p{N}]?[UC]*[LC]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?
    A2  [^\r\n\p{L}\p{N}]?[UC]+[LC]*(?i:...)?
    A3  \p{N}{1,3}
    A4  \x20?[^\s\p{L}\p{N}]+[\r\n/]*
    A5  \s*[\r\n]+
    A6  \s+(?!\S)
    A7  \s+

with UC = [\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}], LC = [\p{Ll}\p{Lm}\p{Lo}\p{M}].

Key insight: PCRE alternation is leftmost-FIRST (not longest), and each
alternative's greedy/backtracking behavior over these character classes
reduces to closed-form expressions on class-run lengths:

* ``[UC]*[LC]+`` with UC/LC overlap (Lm, Lo, M are in both): let R be the
  (UC|LC)-run length at j and p the UC-run length. If p < R the match ends
  at the end of the LC-run at j+p; if p == R it ends just after the *last*
  LC-class char in the run (backtracking gives back UC|LC overlap chars).
* ``\s*[\r\n]+``: ends just after the last [\r\n] char of the whitespace
  run (greedy \s* backtracks to the last newline).
* ``\s+(?!\S)``: the full whitespace run if it ends at end-of-text, else
  run-1 chars (needs >= 2); the classic "hold back one space before a word".

Every character matches some alternative (A7 at worst), so matches tile the
text with no gaps — `finditer` is then: lengths[i] for all i in parallel,
followed by start-position chaining (sequential here; pointer-doubling on
device, see ops/pretokenize.py).

This module is the *reference* for the jnp device kernel and is itself
differentially fuzzed against the `regex` module (tests/test_scanner.py).
"""

from __future__ import annotations

import numpy as np

from .unicode_tables import LC, LETTER, NUM, RN, UC, WS, get_tables

# contraction letter ids
_S, _T, _R, _E, _V, _M, _L, _D = range(8)
_FOLD_ORDER = "strevmld"

_FOLD_ID: np.ndarray | None = None


def _fold_id_table() -> np.ndarray:
    global _FOLD_ID
    if _FOLD_ID is None:
        _, folds = get_tables()
        t = np.full(0x110000, -1, dtype=np.int8)
        for i, letter in enumerate(_FOLD_ORDER):
            t[folds[letter]] = i
        _FOLD_ID = t
    return _FOLD_ID


def _runlen(mask: np.ndarray) -> np.ndarray:
    """r[i] = number of consecutive True at and after i (same length)."""
    n = len(mask)
    idx = np.arange(n, dtype=np.int64)
    nf = np.where(~mask, idx, n)  # position itself if False, else n
    nf = np.minimum.accumulate(nf[::-1])[::-1]  # next False at/after i
    return (nf - idx).astype(np.int32)


def match_lengths(
    cp: np.ndarray, *, contractions: bool = True, profile: str | None = None
) -> np.ndarray:
    """Per-position match length (in chars) for the supported pattern
    profiles: "llama4" (o200k family with contraction alternates),
    "nocontract" (Tekken), "cl100k" (GPT-4 family).

    cp: (n,) int32/int64 codepoints. Returns (n,) int32, all >= 1.
    """
    if profile is None:
        profile = "llama4" if contractions else "nocontract"
    if profile == "cl100k":
        return _match_lengths_cl100k(cp)
    if profile == "gpt2":
        return _match_lengths_gpt2(cp)
    contractions = profile != "nocontract"
    classes, _ = get_tables()
    n = len(cp)
    if n == 0:
        return np.zeros(0, dtype=np.int32)

    cls = classes[cp]
    ws = (cls & WS) != 0
    rn = (cls & RN) != 0
    let = (cls & LETTER) != 0
    num = (cls & NUM) != 0
    uc = (cls & UC) != 0
    lc = (cls & LC) != 0
    wd = uc | lc
    p1 = ~(rn | let | num)  # [^\r\n\p{L}\p{N}]
    pu = ~(ws | let | num)  # [^\s\p{L}\p{N}]
    rns = rn | (cp == ord("/"))
    sp = cp == ord(" ")

    PAD = 4
    z32 = lambda a: np.concatenate([a.astype(np.int32), np.zeros(PAD, np.int32)])
    ws_run = z32(_runlen(ws))
    wd_run = z32(_runlen(wd))
    uc_run = z32(_runlen(uc))
    lc_run = z32(_runlen(lc))
    num_run = z32(_runlen(num))
    pu_run = z32(_runlen(pu))
    rns_run = z32(_runlen(rns))

    idx = np.arange(n, dtype=np.int32)
    # forward cummax of "position if class else -1" — enables O(1) queries of
    # "last class-member at or before j"
    prevrn = np.concatenate(
        [np.maximum.accumulate(np.where(rn, idx, -1)).astype(np.int32),
         np.full(PAD, -1, np.int32)]
    )
    prevlc = np.concatenate(
        [np.maximum.accumulate(np.where(lc, idx, -1)).astype(np.int32),
         np.full(PAD, -1, np.int32)]
    )

    # --- word-part matchers -------------------------------------------------
    def wm1(j: np.ndarray) -> np.ndarray:
        """match length of [UC]*[LC]+ at positions j (0 = no match)."""
        R = wd_run[j]
        p = uc_run[j]
        end_run = j + R - 1
        # p < R: char at j+p is pure-LC; match to end of its LC-run
        lt = p + lc_run[j + p]
        # p == R: backtrack to last LC-class char in the run
        s = prevlc[np.maximum(end_run, 0)]
        eq = np.where((s >= j) & (R > 0), s - j + 1, 0)
        return np.where(R == 0, 0, np.where(p < R, lt, eq)).astype(np.int32)

    def wm2(j: np.ndarray) -> np.ndarray:
        """match length of [UC]+[LC]* at positions j (0 = no match)."""
        p = uc_run[j]
        return np.where(p > 0, p + lc_run[j + p], 0).astype(np.int32)

    # --- contraction suffix -------------------------------------------------
    if contractions:
        fold = _fold_id_table()
        cpp = np.concatenate([cp.astype(np.int64), np.zeros(PAD, np.int64)])
        f1 = fold[cpp[1:]]  # fold id of cp[e+1] at index e
        f1 = np.concatenate([f1, np.full(1, -1, np.int8)])
        f2 = np.concatenate([fold[cpp[2:]], np.full(2, -1, np.int8)])
        apo = np.concatenate([cp == ord("'"), np.zeros(PAD, bool)])
        one = (f1 == _S) | (f1 == _T) | (f1 == _M) | (f1 == _D)
        two = ((f1 == _R) & (f2 == _E)) | ((f1 == _V) & (f2 == _E)) | (
            (f1 == _L) & (f2 == _L)
        )
        ct_full = np.where(apo & one, 2, np.where(apo & two, 3, 0)).astype(np.int32)

        def ct(e: np.ndarray) -> np.ndarray:
            return ct_full[np.minimum(e, n + PAD - 1)]

    else:

        def ct(e: np.ndarray) -> np.ndarray:
            return np.zeros(len(e), dtype=np.int32)

    # --- alternatives -------------------------------------------------------
    j1 = np.minimum(idx + 1, n)  # position after a 1-char prefix

    # A1: optional prefix is greedy — prefix branch taken whenever it yields
    # any word match, even if the no-prefix branch would match longer.
    w_pre = wm1(j1)
    w_nop = wm1(idx)
    a1_pre = p1 & (w_pre > 0)
    a1_len = np.where(
        a1_pre,
        1 + w_pre + ct(idx + 1 + w_pre),
        np.where(w_nop > 0, w_nop + ct(idx + w_nop), 0),
    )

    w2_pre = wm2(j1)
    w2_nop = wm2(idx)
    a2_pre = p1 & (w2_pre > 0)
    a2_len = np.where(
        a2_pre,
        1 + w2_pre + ct(idx + 1 + w2_pre),
        np.where(w2_nop > 0, w2_nop + ct(idx + w2_nop), 0),
    )

    a3_len = np.minimum(num_run[:n], 3)

    # A4: optional literal space prefix, same greedy-prefix rule as A1
    pu_pre = pu_run[j1]
    a4_pre = sp & (pu_pre > 0)
    e1_pre = idx + 1 + pu_pre
    e1_nop = idx + pu_run[:n]
    a4_len = np.where(
        a4_pre,
        1 + pu_pre + rns_run[np.minimum(e1_pre, n)],
        np.where(
            pu_run[:n] > 0, pu_run[:n] + rns_run[np.minimum(e1_nop, n)], 0
        ),
    )

    # A5: \s*[\r\n]+ — ends after the last newline of the whitespace run
    e_ws = idx + ws_run[:n]
    m_rn = prevrn[np.maximum(e_ws - 1, 0)]
    a5_len = np.where(ws[:n] & (m_rn >= idx), m_rn + 1 - idx, 0)

    # A6: \s+(?!\S)
    Lw = ws_run[:n]
    at_eos = (idx + Lw) == n
    a6_len = np.where(
        (Lw > 0) & at_eos, Lw, np.where(Lw >= 2, Lw - 1, 0)
    )

    a7_len = Lw

    lens = np.select(
        [a1_len > 0, a2_len > 0, a3_len > 0, a4_len > 0, a5_len > 0, a6_len > 0],
        [a1_len, a2_len, a3_len, a4_len, a5_len, a6_len],
        default=a7_len,
    ).astype(np.int32)
    return lens


def _match_lengths_cl100k(cp: np.ndarray) -> np.ndarray:
    r"""cl100k_base (GPT-4) pattern:
        '(?i:[sdmt]|ll|ve|re)
        |[^\r\n\p{L}\p{N}]?+\p{L}+      (POSSESSIVE prefix: no backtrack)
        |\p{N}{1,3}
        |\x20?[^\s\p{L}\p{N}]++[\r\n]*
        |\s*[\r\n]
        |\s+(?!\S)
        |\s+
    Differences from the o200k family: leading-apostrophe contraction as
    the FIRST alternative; a single \p{L}+ word class (no case split, no
    marks); a possessive optional prefix (if the prefix char matches but
    no letter follows, the whole alternative fails); no '/' in the punct
    tail; \s*[\r\n] single newline (same closed form as \s*[\r\n]+: both
    end after the last newline of the leading whitespace run).
    """
    classes, _ = get_tables()
    n = len(cp)
    if n == 0:
        return np.zeros(0, dtype=np.int32)

    cls = classes[cp]
    ws = (cls & WS) != 0
    rn = (cls & RN) != 0
    let = (cls & LETTER) != 0
    num = (cls & NUM) != 0
    p1 = ~(rn | let | num)
    pu = ~(ws | let | num)
    sp = cp == ord(" ")

    PAD = 4
    z32 = lambda a: np.concatenate([a.astype(np.int32), np.zeros(PAD, np.int32)])
    ws_run = z32(_runlen(ws))
    let_run = z32(_runlen(let))
    num_run = z32(_runlen(num))
    pu_run = z32(_runlen(pu))
    rn_run = z32(_runlen(rn))

    idx = np.arange(n, dtype=np.int32)
    prevrn = np.concatenate(
        [np.maximum.accumulate(np.where(rn, idx, -1)).astype(np.int32),
         np.full(PAD, -1, np.int32)]
    )

    fold = _fold_id_table()
    cpp = np.concatenate([cp.astype(np.int64), np.zeros(PAD, np.int64)])
    f1 = np.concatenate([fold[cpp[1:]], np.full(1, -1, np.int8)])
    f2 = np.concatenate([fold[cpp[2:]], np.full(2, -1, np.int8)])
    apo = cp == ord("'")

    # C1: '(?i:[sdmt]|ll|ve|re)
    one = (f1[:n] == _S) | (f1[:n] == _D) | (f1[:n] == _M) | (f1[:n] == _T)
    two = ((f1[:n] == _L) & (f2[:n] == _L)) | ((f1[:n] == _V) & (f2[:n] == _E)) | (
        (f1[:n] == _R) & (f2[:n] == _E)
    )
    c1 = np.where(apo & one, 2, np.where(apo & two, 3, 0))

    # C2: possessive prefix + \p{L}+
    j1 = np.minimum(idx + 1, n)
    let_pre = let_run[j1]
    c2 = np.where(
        p1,
        np.where(let_pre > 0, 1 + let_pre, 0),  # possessive: no retry
        np.where(let, let_run[:n], 0),
    )

    c3 = np.minimum(num_run[:n], 3)

    # C4: ' '? punct++ [\r\n]*
    pu_pre = pu_run[j1]
    c4 = np.where(
        sp & (pu_pre > 0),
        1 + pu_pre + rn_run[np.minimum(idx + 1 + pu_pre, n)],
        np.where(
            pu_run[:n] > 0,
            pu_run[:n] + rn_run[np.minimum(idx + pu_run[:n], n)],
            0,
        ),
    )

    # C5: \s*[\r\n] — ends after the last newline of the whitespace run
    e_ws = idx + ws_run[:n]
    m_rn = prevrn[np.maximum(e_ws - 1, 0)]
    c5 = np.where(ws & (m_rn >= idx), m_rn + 1 - idx, 0)

    # C6: \s+(?!\S)
    Lw = ws_run[:n]
    at_eos = (idx + Lw) == n
    c6 = np.where((Lw > 0) & at_eos, Lw, np.where(Lw >= 2, Lw - 1, 0))

    c7 = Lw

    lens = np.select(
        [c1 > 0, c2 > 0, c3 > 0, c4 > 0, c5 > 0, c6 > 0],
        [c1, c2, c3, c4, c5, c6],
        default=c7,
    ).astype(np.int32)
    return np.maximum(lens, 1)


def _match_lengths_gpt2(cp: np.ndarray) -> np.ndarray:
    r"""gpt2 / r50k / p50k pattern:
        '(?:[sdmt]|ll|ve|re)        (CASE-SENSITIVE)
        |\x20?\p{L}+ | \x20?\p{N}+ | \x20?[^\s\p{L}\p{N}]+
        |\s+(?!\S) | \s+
    Simple greedy alternatives over single class runs with an optional
    literal-space prefix (backtracks, which reduces to: with-space branch
    iff a run follows the space)."""
    classes, _ = get_tables()
    n = len(cp)
    if n == 0:
        return np.zeros(0, dtype=np.int32)

    cls = classes[cp]
    ws = (cls & WS) != 0
    let = (cls & LETTER) != 0
    num = (cls & NUM) != 0
    pu = ~(ws | let | num)
    sp = cp == ord(" ")

    PAD = 4
    z32 = lambda a: np.concatenate([a.astype(np.int32), np.zeros(PAD, np.int32)])
    ws_run = z32(_runlen(ws))
    let_run = z32(_runlen(let))
    num_run = z32(_runlen(num))
    pu_run = z32(_runlen(pu))

    idx = np.arange(n, dtype=np.int32)
    j1 = np.minimum(idx + 1, n)

    cpp = np.concatenate([cp.astype(np.int64), np.zeros(PAD, np.int64)])
    c1 = cpp[1:n + 1]
    c2 = cpp[2:n + 2]
    apo = cp == ord("'")
    one = np.isin(c1, (ord("s"), ord("d"), ord("m"), ord("t")))
    two = (
        ((c1 == ord("l")) & (c2 == ord("l")))
        | ((c1 == ord("v")) & (c2 == ord("e")))
        | ((c1 == ord("r")) & (c2 == ord("e")))
    )
    g1 = np.where(apo & one, 2, np.where(apo & two, 3, 0))

    def sp_run(run):
        """' ?<class>+' with the greedy-prefix backtracking rule."""
        pre = run[j1]
        return np.where(
            sp & (pre > 0), 1 + pre, np.where(run[:n] > 0, run[:n], 0)
        )

    g2 = sp_run(let_run)
    g3 = sp_run(num_run)
    g4 = sp_run(pu_run)

    Lw = ws_run[:n]
    at_eos = (idx + Lw) == n
    g5 = np.where((Lw > 0) & at_eos, Lw, np.where(Lw >= 2, Lw - 1, 0))
    g6 = Lw

    lens = np.select(
        [g1 > 0, g2 > 0, g3 > 0, g4 > 0, g5 > 0],
        [g1, g2, g3, g4, g5],
        default=g6,
    ).astype(np.int32)
    return np.maximum(lens, 1)


def split_spans(
    text: str, *, contractions: bool = True, profile: str | None = None
) -> list[tuple[int, int]]:
    """Pretoken (start, end) char spans — finditer equivalent."""
    cp = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32).astype(np.int64)
    lens = match_lengths(cp, contractions=contractions, profile=profile)
    spans: list[tuple[int, int]] = []
    i = 0
    n = len(cp)
    while i < n:
        l = int(lens[i])
        assert l >= 1
        spans.append((i, i + l))
        i += l
    return spans


# ===========================================================================
# Boundary-local piece starts (no chaining)
# ===========================================================================
#
# The chain formulation (starts = pointer-chase over per-position match
# lengths) costs ~350 ms/MB on a v5e: every doubling round is a random
# gather into an HBM-sized array. This section derives the start set
# DIRECTLY: for these pattern profiles, whether a piece starts at i is a
# closed-form function of class-run arithmetic (run starts/ends, last
# newline, case-kind transitions) plus a bounded window of context — all
# computable with forward/reverse scans and static shifts, no gathers.
#
# The derivation (per region kind, llama4/o200k family):
# * NUM runs: nothing else consumes digits, so every digit run is entered
#   at its start and tiled 3-at-a-time -> boundary iff (i - run_start) % 3
#   == 0.
# * WD (uc|lc) runs: word pieces tile the run; with kinds U (uc only),
#   L (lc only), O (both): a piece from entry e ends before the first
#   U-kind after the first L-kind >= e; if no L-kind remains, it ends
#   after the LAST O-kind (A1 backtracking), else consumes the rest (A2).
#   Per-position rules (entry-independent): boundary at U-kind u whose
#   nearest non-O predecessor in the run is L-kind; boundary at lastO+1
#   when no L-kind follows the first U after the last L. Contractions
#   (llama only) absorb 1-2 leading letters of the run after an
#   apostrophe that follows a word end -> suppress claims there and force
#   the entry after the absorbed letters.
# * PU regions and marks (pu = [^\s\p{L}\p{N}] includes M-class marks,
#   which are also wd): within a maximal (PU|mark) run, A1's prefix rule
#   preempts A4 while the pattern alternates [PU][mark-run]; the first PU
#   char followed by non-mark starts an A4 that consumes the remainder.
#   A4's [\r\n/]* tail then absorbs a following {rn,/}-run (across ws/PU
#   region boundaries).
# * WS regions: leading {rn,/} absorbed by a preceding A4 tail; an A5
#   piece ends after the last newline; the pure-ws tail keeps its last
#   char only if it can bind to the next piece (any non-newline ws before
#   a word; a literal space before punct), else A6/A7 split.
#
# Every rule is validated against the chained reference and the `regex`
# oracle by tests/fuzz_scanner.py (class-adversarial corpora).


def _prevpos(mask: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """p[i] = largest j <= i with mask[j], else -1."""
    return np.maximum.accumulate(np.where(mask, idx, -1))


def _nextpos(mask: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
    """p[i] = smallest j >= i with mask[j], else n."""
    return np.minimum.accumulate(np.where(mask, idx, n)[::-1])[::-1]


def _shift_right(a: np.ndarray, k: int, fill) -> np.ndarray:
    out = np.full_like(a, fill)
    if k < len(a):
        out[k:] = a[: len(a) - k]
    return out


def _shift_left(a: np.ndarray, k: int, fill) -> np.ndarray:
    out = np.full_like(a, fill)
    if k < len(a):
        out[: len(a) - k] = a[k:]
    return out


def piece_starts(
    cp: np.ndarray, *, contractions: bool = True, profile: str | None = None
) -> np.ndarray:
    """Boundary-local piece-start flags, (n,) bool.

    Produces exactly np.nonzero-chain(match_lengths) without any
    pointer-chasing; see the derivation comment above.
    """
    if profile is None:
        profile = "llama4" if contractions else "nocontract"
    if profile in ("llama4", "nocontract"):
        return _piece_starts_llama(cp, contractions=profile == "llama4")
    if profile == "cl100k":
        return _piece_starts_cl100k(cp)
    if profile == "gpt2":
        return _piece_starts_gpt2(cp)
    raise NotImplementedError(f"no boundary-local derivation for: {profile}")


def _piece_starts_gpt2(cp: np.ndarray) -> np.ndarray:
    r"""Boundary-local derivation for the gpt2/r50k/p50k pattern
    (see _match_lengths_gpt2). Far simpler than the o200k family: no
    newline alternative, no punct tail, no case-kind analysis.

    Piece structure: the text partitions into maximal class runs
    K in {ws, let, num, pu}; G2/G3/G4 consume a full run (with an
    optional literal-space prefix), G5/G6 split a ws run as
    [run-1 | last char], and G1 carves `'X`/`'XX` contraction pieces at
    apostrophes that head a punct run. Boundary rules:

      * every non-ws run start, unless bound by a preceding space piece
        (the space is then the piece start: \x20? prefix of G2/G3/G4) or
        absorbed as a contraction suffix letter;
      * ws run entry; plus the run's last char when the run has >= 2
        chars and does not end at EOS (G5 holds one char back);
      * the held-back (or single) last ws char binds into the next run
        iff it is a literal space (all three non-ws alternatives take
        the \x20? prefix) and does not end at EOS;
      * `'` heading a punct run, not space-bound, followed by the
        case-SENSITIVE suffix s/d/m/t (2 chars) or ll/ve/re (3 chars)
        is a contraction piece: the suffix letters are absorbed, and a
        piece is forced right after them (mid-letter-run entry).
    """
    n = len(cp)
    if n == 0:
        return np.zeros(0, dtype=bool)
    classes, _ = get_tables()
    cls = classes[cp]
    ws = (cls & WS) != 0
    let = (cls & LETTER) != 0
    num = (cls & NUM) != 0
    pu = ~(ws | let | num)
    sp = cp == ord(" ")
    apo = cp == ord("'")

    def prev(m, k=1):
        return _shift_right(m, k, False)

    def nxt(m, k=1):
        return _shift_left(m, k, False)

    # region partition
    K = np.where(ws, 0, np.where(let, 1, np.where(num, 2, 3))).astype(np.int8)
    newreg = np.ones(n, bool)
    newreg[1:] = K[1:] != K[:-1]

    # ws runs: entry + held-back last char (G5), binding by literal space
    nonws_next = nxt(~ws)               # next char exists and is non-ws
    last_ws_mid = ws & nonws_next       # last ws char of a run not at EOS
    b_ws = (ws & newreg) | (last_ws_mid & prev(ws))
    bind_ws = last_ws_mid & sp          # space prefix of G2/G3/G4

    # contractions (case-sensitive ASCII letters)
    cpp = np.concatenate([cp.astype(np.int64), np.zeros(2, np.int64)])
    c1 = cpp[1 : n + 1]
    c2 = cpp[2 : n + 2]
    one = np.isin(c1, (ord("s"), ord("d"), ord("m"), ord("t")))
    two = (
        ((c1 == ord("l")) & (c2 == ord("l")))
        | ((c1 == ord("v")) & (c2 == ord("e")))
        | ((c1 == ord("r")) & (c2 == ord("e")))
    )
    pu_start = pu & newreg
    ct_ok = apo & pu_start & ~prev(bind_ws)
    ct2 = ct_ok & one
    ct3 = ct_ok & two & ~one
    absorbed_letters = prev(ct2) | prev(ct3) | prev(ct3, 2)
    forced_entry = let & (prev(ct2, 2) | prev(ct3, 3))

    base = b_ws | (newreg & ~ws) | forced_entry
    sup = (prev(bind_ws) & ~ws) | absorbed_letters
    starts = base & ~sup
    starts[0] = True
    return starts


def _piece_starts_cl100k(cp: np.ndarray) -> np.ndarray:
    r"""Boundary-local derivation for the cl100k_base pattern
    (see _match_lengths_cl100k).

    Structure relative to the o200k family derivation: letter runs have
    no case-kind analysis (single \p{L}+ class, marks are punct), punct
    runs are consumed whole by the possessive C4 (no A1-mark
    alternation interior), the C4 tail is [\r\n]* (no '/'), digits tile
    3-at-a-time, the contraction is a standalone leading alternative
    (case-insensitive via the fold table), and C2's prefix class
    [^\r\n\p{L}\p{N}] admits any non-newline whitespace before a word.

    Boundary rules:
      * digit runs: entry + every 3rd char (nothing binds into digits);
      * punct runs: entry, unless bound by an eligible preceding space;
        no interior starts (C4 is possessive over the whole run);
      * a maximal [\r\n] run directly preceded by punct is absorbed by
        that C4 piece's tail;
      * ws runs (minus absorbed newlines): entry; the char after the
        run's last newline (C5 backtracks \s* to it); the run's last
        char when the pure-ws tail has >= 2 chars and does not end at
        EOS; the last char binds into a following letter run (any
        non-newline ws: C2 prefix) or, for a literal space, a following
        punct run (C4 prefix);
      * letter runs: entry, unless bound by an eligible ws char or by a
        single-char punct run piece head (C2 prefix), or absorbed as a
        contraction suffix; forced entry after an absorbed suffix;
      * `'` heading a punct run, not space-bound, followed by the
        case-insensitive fold suffix, is a contraction piece.
    """
    n = len(cp)
    if n == 0:
        return np.zeros(0, dtype=bool)
    classes, _ = get_tables()
    idx = np.arange(n, dtype=np.int64)
    cls = classes[cp]
    ws = (cls & WS) != 0
    rn = (cls & RN) != 0
    let = (cls & LETTER) != 0
    num = (cls & NUM) != 0
    pu = ~(ws | let | num)
    sp = cp == ord(" ")
    apo = cp == ord("'")

    def prev(m, k=1):
        return _shift_right(m, k, False)

    def nxt(m, k=1):
        return _shift_left(m, k, False)

    # region partition (rn is inside ws)
    K = np.where(ws, 0, np.where(let, 1, np.where(num, 2, 3))).astype(np.int8)
    newreg = np.ones(n, bool)
    newreg[1:] = K[1:] != K[:-1]
    reg_start = _prevpos(newreg, idx)
    nxtreg = _nextpos(np.concatenate([newreg[1:], np.zeros(1, bool)]), idx, n)
    rend = np.where(nxtreg < n, nxtreg + 1, n)

    # C4 [\r\n]* tail absorption: a maximal rn-run directly after punct
    rn_seed = rn & ~prev(rn) & prev(pu)
    rn_start = _prevpos(~rn, idx) + 1
    seedpos = _prevpos(rn_seed, idx)
    absorbed = rn & (seedpos >= rn_start)

    # ws rules (cf. _piece_starts_llama.ws_rules, rnsl -> rn, wd -> let)
    ws_entry = ws & ~absorbed & (prev(~ws) | prev(absorbed) | (idx == 0))
    nextrn_l = _nextpos(rn & ~absorbed, idx, n)

    def at(arr, pos, fill):
        out = np.full(len(pos), fill, dtype=arr.dtype)
        ok = (pos >= 0) & (pos < n)
        out[ok] = arr[pos[ok]]
        return out

    is_last_rn = rn & ~absorbed & (at(nextrn_l, idx + 1, n) >= rend)
    b_after_rn = ws & prev(is_last_rn)
    in_tail = ws & ~rn & ~absorbed & (nextrn_l >= rend)
    at_last = in_tail & (idx == rend - 1) & (rend < n)
    eligible = at_last & (nxt(let) | (sp & nxt(pu)))
    b_ws_split = at_last & prev(in_tail)
    bound_into = prev(eligible)
    b_ws = ws_entry | b_after_rn | b_ws_split

    # contractions: `'` heading a punct run, not bound by a space
    fold = _fold_id_table()
    cpp = np.concatenate([cp.astype(np.int64), np.zeros(2, np.int64)])
    f1 = fold[cpp[1 : n + 1]]
    f2 = fold[cpp[2 : n + 2]]
    fold_one = (f1 == _S) | (f1 == _T) | (f1 == _M) | (f1 == _D)
    fold_two = ((f1 == _R) & (f2 == _E)) | ((f1 == _V) & (f2 == _E)) | (
        (f1 == _L) & (f2 == _L)
    )
    pu_start = pu & newreg
    ct_ok = apo & pu_start & ~bound_into
    ct2 = ct_ok & fold_one
    ct3 = ct_ok & fold_two & ~fold_one
    ct_any = ct2 | ct3
    absorbed_letters = prev(ct2) | prev(ct3) | prev(ct3, 2)
    forced_entry = let & (prev(ct2, 2) | prev(ct3, 3)) & ~absorbed_letters

    # C2 prefix binding by a single-char punct piece head: a punct run
    # start that is itself a piece start, is not a contraction, and is
    # directly followed by a letter (run length 1 by construction)
    bind_pu = pu_start & ~bound_into & ~ct_any & nxt(let)

    b_num = num & (((idx - reg_start) % 3) == 0)

    base = b_ws | b_num | (newreg & (let | pu)) | forced_entry
    sup = absorbed | absorbed_letters | bound_into | prev(bind_pu)
    starts = base & ~sup
    starts[0] = True
    return starts


def _piece_starts_llama(cp: np.ndarray, *, contractions: bool) -> np.ndarray:
    classes, _ = get_tables()
    n = len(cp)
    if n == 0:
        return np.zeros(0, dtype=bool)
    idx = np.arange(n, dtype=np.int64)

    cls = classes[cp]
    ws = (cls & WS) != 0
    rn = (cls & RN) != 0
    let = (cls & LETTER) != 0
    num = (cls & NUM) != 0
    uc = (cls & UC) != 0
    lc = (cls & LC) != 0
    wd = uc | lc
    pu_re = ~(ws | let | num)          # the regex class [^\s\p{L}\p{N}]
    mark = pu_re & wd                  # M-class: in both pu and wd
    sp = cp == ord(" ")
    apo = cp == ord("'")
    rnsl = rn | (cp == ord("/"))

    U = uc & ~lc
    L = lc & ~uc
    O = uc & lc

    def prev(m, k=1):
        return _shift_right(m, k, False)

    def nxt(m, k=1):
        return _shift_left(m, k, False)

    def at(arr, pos, fill):
        out = np.full(len(pos), fill, dtype=arr.dtype)
        ok = (pos >= 0) & (pos < n)
        out[ok] = arr[pos[ok]]
        return out

    def _ffill_at(entry: np.ndarray, val: np.ndarray) -> np.ndarray:
        """Value of `val` at the latest entry position <= i (-1 if none)."""
        enc = np.where(entry, idx * (np.int64(n) + 2) + (val + 1), -1)
        enc = np.maximum.accumulate(enc)
        return np.where(enc >= 0, enc % (np.int64(n) + 2) - 1, -1)

    rnsl_start = _prevpos(~rnsl, idx) + 1
    mr_start = _prevpos(~mark, idx) + 1

    if contractions:
        fold = _fold_id_table()
        cpp = np.concatenate([cp.astype(np.int64), np.zeros(2, np.int64)])
        f1 = fold[cpp[1 : n + 1]]
        f2 = fold[cpp[2 : n + 2]]
        fold_one = (f1 == _S) | (f1 == _T) | (f1 == _M) | (f1 == _D)
        fold_two = ((f1 == _R) & (f2 == _E)) | ((f1 == _V) & (f2 == _E)) | (
            (f1 == _L) & (f2 == _L)
        )
    else:
        fold_one = np.zeros(n, bool)
        fold_two = np.zeros(n, bool)

    # ================= mutually-recursive core ============================
    # ct (contraction absorption) needs to know which marks are word
    # material (not eaten by an A4), and the (PU|mark)-run analysis must
    # exclude ct-absorbed apostrophes from punct runs. Two fixpoint rounds
    # resolve realistic texts (each round settles one more link of any
    # apostrophe/punct chain); the device port carries the same loop.
    ct2 = np.zeros(n, bool)
    ct3 = np.zeros(n, bool)
    for _round in range(2):
        PUx = pu_re & ~wd & ~(ct2 | ct3)   # effective pure-punct chars
        purc = PUx | mark
        pur_start = _prevpos(~purc, idx) + 1
        bad = PUx & ~nxt(mark)
        nbad = _nextpos(bad, idx, n)

        def a4_cover(bound_into, absorbed):
            entry = purc & ((idx == pur_start) | (~absorbed & prev(absorbed)))
            start_cover = PUx & bound_into & (idx == pur_start)
            seedval = np.where(start_cover, idx, nbad)
            cover_from = _ffill_at(entry, seedval)
            covered = purc & (cover_from >= 0) & (idx >= cover_from)
            return covered, cover_from

        def absorption(a4_valid):
            t0 = rn & prev(a4_valid & purc)
            pt0 = _prevpos(t0, idx)
            return rnsl & (pt0 >= rnsl_start)

        # region partition / rend (needed by ws rules)
        K = np.where(ws, 0, np.where(num, 1, np.where(wd, 2, 3))).astype(np.int8)
        newreg = np.ones(n, bool)
        newreg[1:] = K[1:] != K[:-1]
        reg_start = _prevpos(newreg, idx)
        nxtreg = _nextpos(np.concatenate([newreg[1:], np.zeros(1, bool)]), idx, n)
        rend = np.where(nxtreg < n, nxtreg + 1, n)

        def ws_rules(absorbed):
            ws_entry = ws & ~absorbed & (prev(~ws) | prev(absorbed) | (idx == 0))
            nextrn_l = _nextpos(rn & ~absorbed, idx, n)
            is_last_rn = rn & ~absorbed & (at(nextrn_l, idx + 1, n) >= rend)
            b_after_rn = ws & prev(is_last_rn)
            in_tail = ws & ~rn & ~absorbed & (nextrn_l >= rend)
            tail_start = in_tail & ~prev(in_tail)
            tail_start_pos = np.where(in_tail, _prevpos(tail_start, idx), -1)
            at_last = in_tail & (idx == rend - 1) & (rend < n)
            eligible = at_last & ((nxt(wd) & ~rn) | (sp & nxt(pu_re)))
            b_ws_split = at_last & (tail_start_pos >= 0) & (idx > tail_start_pos)
            bound_into = prev(eligible)
            b_ws = (ws_entry | b_after_rn | b_ws_split) & ws
            return b_ws, bound_into

        absorbed = np.zeros(n, bool)
        for _ in range(4):
            a4_covered, cover_from = a4_cover(np.zeros(n, bool), absorbed)
            absorbed = absorption(a4_covered)
        _, bound_into0 = ws_rules(absorbed)
        for _ in range(4):
            a4_covered, cover_from = a4_cover(bound_into0, absorbed)
            absorbed = absorption(a4_covered)
        flow_marks = mark & at(a4_covered & PUx & ~absorbed, mr_start - 1, False)
        b_ws, bound_into = ws_rules(absorbed)

        if not contractions:
            break
        # ---- contraction absorption ------------------------------------
        # word-material = letters, plus marks not eaten by an A4
        word_end_char = (wd & ~mark) | (
            mark & ~(flow_marks | (a4_covered & mark))
        )
        ct2 = apo & prev(word_end_char) & fold_one
        ct3 = apo & prev(word_end_char) & fold_two & ~fold_one
        # chained groups: a fully-absorbed suffix cannot justify the next
        # ct (alternating states; candidates are rare -> sequential walk)
        cand = np.nonzero(ct2 | ct3)[0]
        suffix_end = -10
        for a in cand:
            if a == suffix_end:
                ct2[a] = ct3[a] = False
                suffix_end = -10
                continue
            ln = 2 if ct2[a] else 3
            nxt_pos = a + ln
            exact = nxt_pos >= n or not wd[nxt_pos]
            suffix_end = nxt_pos if exact else -10

    ct_any = ct2 | ct3
    absorbed_letters = prev(ct2) | prev(ct3) | prev(ct3, 2)
    forced_entry = wd & (prev(ct2, 2) | prev(ct3, 3)) & ~absorbed_letters

    # ================= boundary rules =====================================
    # ---- WS / NUM ---------------------------------------------------------
    b_num = num & (((idx - reg_start) % 3) == 0)

    # ---- WD runs ------------------------------------------------------------
    # contraction-absorbed letters end the preceding piece, so the word
    # rules' run restarts after them (the absorbed 're of x're must not act
    # as an L-kind predecessor for the next piece's case analysis)
    wd_start = _prevpos(~wd | absorbed_letters, idx) + 1
    pL = _prevpos(L, idx)
    pU = _prevpos(U, idx)
    nL = _nextpos(L, idx, n)
    nO = _nextpos(O, idx, n)
    wd_end = _nextpos(~wd, idx, n)
    p_prev_L = _shift_right(pL, 1, -1)
    p_prev_U = _shift_right(pU, 1, -1)
    r1 = U & (p_prev_L > p_prev_U) & (p_prev_L >= wd_start)
    r2 = U & prev(O) & (nO >= wd_end) & (nL >= wd_end) & ~r1

    b_wd = (r1 | r2 | forced_entry) & ~absorbed_letters & ~flow_marks
    b_wd |= wd & ~mark & prev(flow_marks)

    # ---- PU interior: alternation entries ----------------------------------
    PUx = pu_re & ~wd & ~ct_any
    purc = PUx | mark
    pur_alt = PUx & prev(mark) & (idx > pur_start) & (
        ~a4_covered | (idx == cover_from)
    )
    b_pu = pur_alt & ~absorbed

    # ---- assemble ------------------------------------------------------------
    base = np.zeros(n, bool)
    base |= b_ws
    base |= b_num
    base |= b_wd
    base |= b_pu
    K = np.where(ws, 0, np.where(num, 1, np.where(wd, 2, 3))).astype(np.int8)
    newreg = np.ones(n, bool)
    newreg[1:] = K[1:] != K[:-1]
    base |= newreg & ~ws & ~purc
    base |= purc & (idx == pur_start)
    base |= purc & ~absorbed & prev(absorbed)

    sup = np.zeros(n, bool)
    sup |= absorbed | flow_marks | absorbed_letters | bound_into
    sup |= ct_any
    # word-attached marks never start — unless a contraction absorbed the
    # letters before them, forcing an entry exactly here
    pnm = _prevpos(~mark, idx)
    word_attached_mark = mark & at((wd & ~mark), pnm, False)
    sup |= word_attached_mark & ~forced_entry

    p1 = ~(rn | let | num)
    base_start = np.where(
        ws, base & ~sup,
        np.where(num, base,
                 np.where(purc & ~wd, base & ~sup, False)),
    ).astype(bool)
    prefix_bind = wd & prev(base_start & p1 & ~wd & ~absorbed_letters)
    sup |= prefix_bind

    starts = base & ~sup
    starts[0] = n > 0
    return starts
