r"""Piece starts: bit-plane derivation and kernel K1.

For a supported pattern profile (llama4/o200k, nocontract/Tekken, cl100k,
gpt2, kimi/Kimi K2) two entry points turn windows into piece-start flags:

* ``piece_starts_bits``: ASCII windows of raw bytes, the counterpart of
  the JAX package's ``ops/bitplane.piece_starts_bits_pallas(...,
  ascii_fast=True)``;
* ``piece_starts_chars``: windows of codepoints (any UTF-8 text, decoded
  by ``ops/pretokenize.utf8_decode``), with the contract of the JAX
  ``pretokenize.compute_starts`` and ``bitplane.piece_starts_bits(...,
  ascii_fast=False)``. Classes come from the per-codepoint table
  ``unicode_tables.char_class_words``. With ``hot_cps`` it takes the
  route of the JAX ``piece_starts_bits_pallas(..., hot_cps=...)``: the
  classes come from ``class_lookup_hot`` (hot codepoints by compare, the
  rest looked up on a prefix compacted by kernel K5+K6 and put back by
  K7+K8) and go into K1's class-word entry (``piece_starts_words``).

Each of them:

* on CUDA tensors launches kernel K1 (``csrc/piece_starts.cu``), which
  builds the class planes and runs the whole derivation in one launch
  (one per group of windows, for a batch of more windows than the card
  holds blocks). Codepoint rows of at most ``ROW_MAX_CHARS`` chars (the
  batched grids' rows, and the engine's 4 KB window) take K1's row entry
  ``piece_starts_rows`` instead: one block per row, its planes in shared
  memory;
* on CPU tensors runs the plain version below, a line-for-line port of
  the reference's word-space derivation.

Plain version layout (as the reference): plane-major — word w's bit j is
char ``j*C + w`` (C = N/32). Words are int32 tensors carrying the uint32
bits; torch's int32 ``>>`` is arithmetic and its shifts by 32 or more are
not portable, so every shift goes through ``_shl``/``_shr``. Every scan is
the first-order recurrence ``s[w] = (s[w-1] & a[w]) | b[w]`` over the char
stream, computed by log-doubling along words and a 5-step chain of the 32
plane carries (``_affine_fwd``).

Exactness: held equal to the JAX package's Pallas kernel (interpret mode)
and to ``scanner_ref`` in tests/test_torch_bitplane.py; the kernel is held
equal to this plain version on the card by chip_smoke.py. The kimi
profile, which the JAX package lacks, runs ``_han_prepass`` in front of
the o200k derivation; tests/test_torch_kimi.py holds it to ``regex`` V1's
split of Kimi K2's pattern and tests/test_torch_cuda.py the kernel to it
on the card.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..unicode_tables import (
    CLASS_WORD_BITS, LC, N_CP, NUM, RN, UC, WS, char_class_words, get_tables,
)
from .join import to_i32

_ALL1 = -1  # 0xFFFFFFFF as an int32 word


# ===========================================================================
# Packing
# ===========================================================================


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., N/32) int32 words, plane-major: word w bit j
    = mask[j*C + w]. N must be a multiple of 32."""
    n = mask.shape[-1]
    if n % 32:
        raise ValueError(f"length {n} is not a multiple of 32")
    c = n // 32
    rows = mask.reshape(mask.shape[:-1] + (32, c)).to(torch.int64)
    sh = torch.arange(32, device=mask.device)[:, None]
    return to_i32((rows << sh).sum(dim=-2))


def unpack_mask(w: torch.Tensor) -> torch.Tensor:
    """(..., C) words -> (..., 32*C) bool (inverse of pack_mask)."""
    sh = torch.arange(32, device=w.device)[:, None]
    bits = ((w.to(torch.int64) & 0xFFFFFFFF)[..., None, :] >> sh) & 1
    return bits.to(torch.bool).reshape(w.shape[:-1] + (-1,))


# ===========================================================================
# Word-space primitives on the last axis; semantics on the char stream
# x[i] (i = plane*C + word)
# ===========================================================================


def _shl(x: torch.Tensor, k: int) -> torch.Tensor:
    if k >= 32:
        return torch.zeros_like(x)
    return x << k if k else x


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words."""
    if k >= 32:
        return torch.zeros_like(x)
    return (x >> k) & ((1 << (32 - k)) - 1) if k else x


def prevk(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = x[i-k], False for i < k."""
    c = x.shape[-1]
    q, s = divmod(k, c)
    if q >= 32:
        return torch.zeros_like(x)
    if s == 0:
        return _shl(x, q)
    hi = _shl(x[..., c - s :], q + 1)  # words [0, s): plane below
    lo = _shl(x[..., : c - s], q)      # words [s, C)
    return torch.cat([hi, lo], dim=-1)


def nxtk(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = x[i+k], False for i >= N-k."""
    c = x.shape[-1]
    q, s = divmod(k, c)
    if q >= 32:
        return torch.zeros_like(x)
    if s == 0:
        return _shr(x, q)
    lo = _shr(x[..., s:], q)           # words [0, C-s)
    hi = _shr(x[..., :s], q + 1)       # words [C-s, C): plane above
    return torch.cat([lo, hi], dim=-1)


def _shift_words(x, k, fill, *, rev):
    f = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype, device=x.device)
    return (torch.cat([x[..., k:], f], dim=-1) if rev
            else torch.cat([f, x[..., :-k]], dim=-1))


def _affine_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s[i] = (s[i-1] & a[i]) | b[i] over the char stream, s[-1] = 0."""
    c = a.shape[-1]
    A, B = a, b
    k = 1
    while k < c:
        A_sh = _shift_words(A, k, _ALL1, rev=False)
        B_sh = _shift_words(B, k, 0, rev=False)
        B = (B_sh & A) | B
        A = A_sh & A
        k *= 2
    Aw, Bw = A[..., -1], B[..., -1]
    k = 1
    while k < 32:
        low1 = (1 << k) - 1
        Aw, Bw = (_shl(Aw, k) | low1) & Aw, (_shl(Bw, k) & Aw) | Bw
        k *= 2
    t = _shl(Bw, 1)[..., None]
    return (t & A) | B


def _affine_rev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s[i] = (s[i+1] & a[i]) | b[i], s[N] = 0 (suffix mirror)."""
    c = a.shape[-1]
    A, B = a, b
    k = 1
    while k < c:
        A_sh = _shift_words(A, k, _ALL1, rev=True)
        B_sh = _shift_words(B, k, 0, rev=True)
        B = (B_sh & A) | B
        A = A_sh & A
        k *= 2
    Aw, Bw = A[..., 0], B[..., 0]
    k = 1
    while k < 32:
        top1 = ((1 << k) - 1) << (32 - k)
        top1 -= 2**32 if top1 >= 2**31 else 0
        Aw, Bw = (_shr(Aw, k) | top1) & Aw, (_shr(Bw, k) & Aw) | Bw
        k *= 2
    t = _shr(Bw, 1)[..., None]
    return (t & A) | B


def seg_or_fwd(x: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """out[i] = OR of x[j] for j <= i with no reset at any t in (j, i]."""
    return _affine_fwd(~reset, x)


def seg_or_rev(x: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """out[i] = OR of x[j] for j >= i with no reset at any t in (i, j]."""
    return _affine_rev(~nxtk(reset, 1), x)


def or_scan_fwd(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix OR."""
    c = x.shape[-1]
    B = x
    k = 1
    while k < c:
        B = B | _shift_words(B, k, 0, rev=False)
        k *= 2
    t = B[..., -1]
    k = 1
    while k < 32:
        t = t | _shl(t, k)
        k *= 2
    return B | _shl(t, 1)[..., None]


def xor_scan_fwd(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR."""
    c = x.shape[-1]
    B = x
    k = 1
    while k < c:
        B = B ^ _shift_words(B, k, 0, rev=False)
        k *= 2
    t = B[..., -1]
    k = 1
    while k < 32:
        t = t ^ _shl(t, k)
        k *= 2
    return B ^ _shl(t, 1)[..., None]


def ffill_bool(sample: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Value of x at the latest sample position <= i; False if none."""
    return seg_or_fwd(sample & x, sample & ~x)


def stride_marks(seed: torch.Tensor, carrier: torch.Tensor, stride: int,
                 n: int) -> torch.Tensor:
    """Positions reachable from a seed by repeated +stride steps where
    every char of each step span lies in ``carrier``."""
    span = carrier
    for j in range(1, stride):
        span = span & prevk(carrier, j)
    out = seed
    step = stride
    while step < n:
        out = out | (prevk(out, step) & span)
        span = span & prevk(span, step)
        step *= 2
    return out


def _at0_like(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[..., 0] = 1
    return out


# ===========================================================================
# Plane-space ASCII mask construction: bytes -> packed class words
# ===========================================================================

# contraction fold-letter ids (index into scanner_ref._FOLD_ORDER)
_S, _T, _R, _E, _V, _M, _L, _D = range(8)


@lru_cache(maxsize=1)
def _ascii_class_members():
    """Member byte sets per class bit + fold-letter sets (ASCII only)."""
    from ..scanner_ref import _FOLD_ORDER

    table, folds = get_tables()
    classes = {}
    for name, bit in (("ws", WS), ("rn", RN), ("num", NUM), ("uc", UC),
                      ("lc", LC)):
        classes[name] = frozenset(b for b in range(128) if table[b] & bit)
    classes["sp"] = frozenset([ord(" ")])
    classes["apo"] = frozenset([ord("'")])
    classes["rnsl"] = classes["rn"] | {ord("/")}
    fold = {
        i: frozenset(c for c in folds[L].tolist() if c < 128)
        for i, L in enumerate(_FOLD_ORDER)
    }
    return classes, fold


def _pack_byte_planes(by: torch.Tensor):
    """(..., N) bytes -> 7 packed (..., N/32) bit-planes in pack_mask
    layout (plane i word w bit p = bit i of byte[p*C + w])."""
    b = by.to(torch.int64)
    return [pack_mask(((b >> i) & 1).to(torch.bool)) for i in range(7)]


def _valid_words(m: torch.Tensor, c: int) -> torch.Tensor:
    """Packed validity plane for lengths m (..., 1): bit p of word w =
    (p*C + w < m); a word is a low-bit run of ceil((m-w)/C) bits."""
    w = torch.arange(c, device=m.device)
    t = torch.clamp(torch.div(m.to(torch.int64) - w + (c - 1), c,
                              rounding_mode="floor"), 0, 32)
    run = torch.bitwise_left_shift(torch.ones_like(t), t.clamp(max=31)) - 1
    return to_i32(torch.where(t >= 32, 0xFFFFFFFF, run))


def _char_masks_planes(by: torch.Tensor, m: torch.Tensor, *,
                       contractions: bool, profile: str = "llama4"):
    """ascii_fast mask construction in plane space for a batch: ``by`` is
    (B, N) bytes (anything at positions >= m), ``m`` (B,) lengths.
    Returns the dict of packed (B, C) words by mask name. For
    profile="gpt2" the fold planes carry the case-sensitive suffix
    letters instead of the fold-table ones."""
    n = by.shape[-1]
    c = n // 32
    valid = _valid_words(m.reshape(-1, 1), c)
    b = [p & valid for p in _pack_byte_planes(by)]
    nb = [~p for p in b[:4]]
    lo_eq = [
        (b[0] if v & 1 else nb[0]) & (b[1] if v & 2 else nb[1])
        & (b[2] if v & 4 else nb[2]) & (b[3] if v & 8 else nb[3])
        for v in range(16)
    ]
    nb4, nb5, nb6 = ~b[4], ~b[5], ~b[6]
    hi_eq = [
        (b[4] if h & 1 else nb4) & (b[5] if h & 2 else nb5)
        & (b[6] if h & 4 else nb6)
        for h in range(8)
    ]

    def members(mset):
        out = None
        for h in range(8):
            row = [v for v in range(16) if (h << 4) | v in mset]
            if not row:
                continue
            if len(row) == 16 and h != 0:
                t = hi_eq[h]
            else:
                rr = lo_eq[row[0]]
                for v in row[1:]:
                    rr = rr | lo_eq[v]
                t = hi_eq[h] & rr
            out = t if out is None else (out | t)
        return out if out is not None else torch.zeros_like(valid)

    classes, fold = _ascii_class_members()
    ws = members(classes["ws"])
    rn = members(classes["rn"])
    uc = members(classes["uc"])
    lc = members(classes["lc"])
    let = uc | lc
    num = members(classes["num"])
    sp = members(classes["sp"])
    apo = members(classes["apo"])
    rnsl = rn | members(classes["rnsl"] - classes["rn"])
    if profile == "kimi":  # punctuation tail [\r\n]*; ASCII has no Han
        rnsl = rn

    if profile == "gpt2":
        lit = {ch: members(frozenset([ord(ch)])) for ch in "sdmtlver"}
        fold_one = nxtk(lit["s"] | lit["d"] | lit["m"] | lit["t"], 1)
        fold_two = (
            (nxtk(lit["l"], 1) & nxtk(lit["l"], 2))
            | (nxtk(lit["v"], 1) & nxtk(lit["e"], 2))
            | (nxtk(lit["r"], 1) & nxtk(lit["e"], 2))
        )
    elif contractions:
        f = {i: members(fold[i]) for i in range(8)}
        fold_one = nxtk(f[_S] | f[_T] | f[_M] | f[_D], 1)
        fold_two = (nxtk(f[_R] | f[_V], 1) & nxtk(f[_E], 2)) | (
            nxtk(f[_L], 1) & nxtk(f[_L], 2)
        )
    else:
        fold_one = torch.zeros_like(valid)
        fold_two = torch.zeros_like(valid)
    return dict(
        valid=valid, ws=ws, rn=rn, let=let, num=num, uc=uc, lc=lc,
        sp=sp, apo=apo, rnsl=rnsl, fold1=fold_one, fold2=fold_two,
        han=torch.zeros_like(valid),
    )


# ===========================================================================
# The derivation in word space (verbatim from the reference)
# ===========================================================================


def derive_starts_words(
    P: dict, *, contractions: bool, n_total: int,
    profile: str | None = None,
) -> torch.Tensor:
    """Word-space derivation: packed masks -> packed start flags.
    Shape-agnostic over leading axes (last axis = words). Dispatches on
    profile: o200k family (llama4/nocontract) below, cl100k/gpt2 in
    their own word-space derivations."""
    if profile == "cl100k":
        return _derive_cl100k_words(P, n_total=n_total)
    if profile == "gpt2":
        return _derive_gpt2_words(P, n_total=n_total)
    b_num = None
    if profile == "kimi":
        P, b_num = _han_prepass(P, n_total=n_total)
    valid, ws, rn, let, num = P["valid"], P["ws"], P["rn"], P["let"], P["num"]
    uc, lc, sp, apo, rnsl = P["uc"], P["lc"], P["sp"], P["apo"], P["rnsl"]
    fold1, fold2 = P["fold1"], P["fold2"]

    wd = uc | lc
    pu_re = ~(ws | let | num) & valid
    mark = pu_re & wd
    U = uc & ~lc
    L = lc & ~uc
    O = uc & lc
    at0 = _at0_like(valid)

    def prev1(x):
        return prevk(x, 1)

    def nxt1(x):
        return nxtk(x, 1)

    # region partition: newreg[i] = class(i) != class(i-1), True at 0
    # (piece_starts_jax:712-716; categories in priority order ws/num/wd/
    # other/invalid)
    k0 = ws
    k1 = num & ~ws
    k2 = wd & ~ws & ~num
    k3 = valid & ~ws & ~num & ~wd
    k4 = ~valid
    same = (
        (k0 & prev1(k0)) | (k1 & prev1(k1)) | (k2 & prev1(k2))
        | (k3 & prev1(k3)) | (k4 & prev1(k4))
    )
    if b_num is not None:  # kimi: each Han run piece is a region of its own
        k5 = P["han"]
        k3 = k3 & ~k5
        same = (
            (k0 & prev1(k0)) | (k1 & prev1(k1)) | (k2 & prev1(k2))
            | (k3 & prev1(k3)) | (k4 & prev1(k4)) | (k5 & prev1(k5))
        )
    newreg = ~same  # char 0: all prev1 False -> newreg set

    def a4_cover_b(bound_into, absorbed, PUx, purc, bad):
        """a4_cover (piece_starts_jax:732-739) in run algebra.
        covered[i] = purc & entry-exists & (last entry was start_cover
        | bad seen in [last_entry, i]); eq_cover[i] = idx == cover_from."""
        run_start = purc & ~prev1(purc)       # idx == pur_start
        entry = purc & (run_start | (~absorbed & prev1(absorbed)))
        start_cover = PUx & bound_into & run_start
        sc_fill = ffill_bool(entry, start_cover)
        bad_since = seg_or_fwd(bad, entry)
        hasentry = or_scan_fwd(entry)
        covered = purc & hasentry & (sc_fill | bad_since)
        first_bad_since = bad & (entry | ~prev1(bad_since))
        eq_cover = (entry & start_cover) | (
            hasentry & ~sc_fill & first_bad_since
        )
        return covered, eq_cover

    def absorption_b(a4_valid, purc):
        """absorption (:741-744): pt0 >= rnsl_start <=> a t0 inside the
        current rnsl run (resets at ~rnsl cut older runs)."""
        t0 = rn & prev1(a4_valid & purc)
        return rnsl & seg_or_fwd(t0, ~rnsl)

    def ws_rules_b(absorbed):
        """ws_rules (:746-763). nextrn_l/rend/tail_start_pos comparisons
        become segmented ORs over the region partition."""
        ws_entry = ws & ~absorbed & (prev1(~ws) | prev1(absorbed) | at0)
        x = rn & ~absorbed
        e_x = seg_or_rev(x, newreg)           # an x at j>=i in i's region
        exists_later = nxt1(e_x) & ~nxt1(newreg)
        is_last_rn = x & ~exists_later
        in_tail = ws & ~rn & ~absorbed & ~e_x
        b_after_rn = ws & prev1(is_last_rn)
        at_last = in_tail & nxt1(newreg & valid)  # idx==rend-1 & rend<m
        eligible = at_last & ((nxt1(wd) & ~rn) | (sp & nxt1(pu_re)))
        b_ws_split = at_last & prev1(in_tail)  # idx > tail_start_pos
        bound_into = prev1(eligible)
        b_ws = (ws_entry | b_after_rn | b_ws_split) & ws
        return b_ws, bound_into

    # ================= mutually-recursive core (:721-792) =================
    zero = torch.zeros_like(valid)
    ct2 = zero
    ct3 = zero
    n_rounds = 2 if contractions else 1
    for _round in range(n_rounds):
        PUx = pu_re & ~wd & ~(ct2 | ct3)
        purc = PUx | mark
        bad = PUx & ~nxt1(mark)

        absorbed = zero
        for _ in range(4):
            a4_covered, eq_cover = a4_cover_b(zero, absorbed, PUx, purc, bad)
            absorbed = absorption_b(a4_covered, purc)
        _, bound_into0 = ws_rules_b(absorbed)
        for _ in range(4):
            a4_covered, eq_cover = a4_cover_b(
                bound_into0, absorbed, PUx, purc, bad
            )
            absorbed = absorption_b(a4_covered, purc)
        flow_marks = mark & ffill_bool(~mark, a4_covered & PUx & ~absorbed)
        b_ws, bound_into = ws_rules_b(absorbed)

        if not contractions:
            break
        # ---- contraction absorption (:783-792) ---------------------------
        word_end_char = (wd & ~mark) | (
            mark & ~(flow_marks | (a4_covered & mark))
        )
        pwe = prev1(word_end_char)
        ct2 = apo & pwe & fold1
        ct3 = apo & pwe & fold2 & ~fold1
        exact2 = ~nxtk(wd, 2)
        exact3 = ~nxtk(wd, 3)
        # _ct_chain_accept (:610-644): parity of candidate count since the
        # latest chain start — prefix XOR + boolean fill
        cand = ct2 | ct3
        link_in = cand & (
            (prevk(ct2 & exact2, 2) & ~prev1(cand))
            | (prevk(ct3 & exact3, 3) & ~prev1(cand) & ~prevk(cand, 2))
        )
        par = xor_scan_fwd(cand)
        chain_start = cand & ~link_in
        par_at_start = ffill_bool(chain_start, par)
        rej = cand & (par ^ par_at_start)
        ct2 = ct2 & ~rej
        ct3 = ct3 & ~rej

    purc_loop = purc  # loop-scoped purc: pur_start below is NOT recomputed

    ct_any = ct2 | ct3
    absorbed_letters = prev1(ct2) | prev1(ct3) | prevk(ct3, 2)
    forced_entry = wd & (prevk(ct2, 2) | prevk(ct3, 3)) & ~absorbed_letters

    # ================= boundary rules (:798-844) ==========================
    if b_num is None:
        b_num = num & stride_marks(num & newreg, num, 3, n_total)

    # word rules: r1 needs "an L in [wd_start, i-1] after the last U";
    # r2 needs "no O/L from i to the wd-run end" (breaks at ~wd only).
    # An L that IS a break (an absorbed contraction letter) sits below
    # wd_start in the positional form, so it must not seed the scan
    # (seg resets only sever strictly-later positions).
    brk_w = ~wd | absorbed_letters
    l_after_u = seg_or_fwd(L & ~absorbed_letters, U | brk_w)
    r1 = U & prev1(l_after_u)
    r2 = U & prev1(O) & ~seg_or_rev(O | L, ~wd) & ~r1

    b_wd = (r1 | r2 | forced_entry) & ~absorbed_letters & ~flow_marks
    b_wd = b_wd | (wd & ~mark & prev1(flow_marks))

    # ---- PU interior: alternation entries (:817-823) ---------------------
    PUx_f = pu_re & ~wd & ~ct_any
    purc_f = PUx_f | mark
    in_run_past_start = purc_loop & prev1(purc_loop)  # idx > pur_start
    pur_alt = PUx_f & prev1(mark) & in_run_past_start & (
        ~a4_covered | eq_cover
    )
    b_pu = pur_alt & ~absorbed

    # ---- assemble (:825-844) ---------------------------------------------
    run_start_loop = purc_loop & ~prev1(purc_loop)    # idx == pur_start
    base = b_ws | b_num | b_wd | b_pu
    base = base | (newreg & ~ws & ~purc_f & valid)
    base = base | (purc_f & run_start_loop)
    base = base | (purc_f & ~absorbed & prev1(absorbed))

    sup = absorbed | flow_marks | absorbed_letters | bound_into | ct_any
    wam = mark & ffill_bool(~mark, wd & ~mark)
    sup = sup | (wam & ~forced_entry)

    p1 = ~(rn | let | num) & valid
    ns = base & ~sup
    base_start = (
        (ws & ns) | (~ws & num & base) | (~ws & ~num & purc_f & ~wd & ns)
    )
    prefix_bind = wd & prev1(base_start & p1 & ~wd & ~absorbed_letters)
    sup = sup | prefix_bind

    starts = base & ~sup & valid
    # char 0: start iff m > 0 == valid bit 0 of word 0
    starts = (starts & ~at0) | (valid & at0)
    return starts


def _han_prepass(P: dict, *, n_total: int):
    """The kimi profile's Han rules, as planes for the o200k derivation.

    Kimi K2's pattern tries ``[\\p{Han}]+`` first, and its word classes
    leave Han out (``char_class_words("kimi")`` has no UC or LC on Han).
    So a piece that starts on a Han char is the rest of that char's Han
    run, and no piece that starts elsewhere takes a Han letter. Two
    alternatives may still run on into Han chars that are not letters
    (they *swallow* them): the punctuation body ``[^\\s\\p{L}\\p{N}]+``
    takes Han So/Po/Mc chars (the radicals, U+16FE2, U+16FF0-1), and
    ``\\p{N}{1,3}`` takes Han Nl chars (U+3007 and the Hangzhou numerals).
    Every other Han char belongs to a Han run piece. Written as the text
    with each such char a class of its own (``han``: no ``num``, but
    ``let``, so no prefix, punctuation or word binds to it, and a region
    of its own in the derivation), the o200k derivation over it gives
    Kimi K2's starts exactly.

    * A Han punctuation char is swallowed where the piece before it is in
      a punctuation body, or is the space of `` ?``: one forward scan
      ``b``. A non-Han punctuation char P (not a mark) starts or continues
      a body, unless a word char follows it, as it then is the prefix of
      a word (only after a space, which takes the body first, does it
      stay in one); a mark or a Han punctuation char keeps ``b``.
    * Digit groups: the state c_i of char i in ``\\p{N}{1,3}`` (0, 1, 2:
      its place in a group; 2 also for a char outside any group) moves by
      D (a non-Han digit) 0->1->2->0, by H (a Han digit) 0->1, 1->2,
      2->2 (a Han digit at a group's start begins a Han run) and by any
      other char to 2. Maps of {0,1,2} compose by doubling the span
      (``ceil(log2 n)`` steps, 2 bits an input); a Han digit with c_{i-1}
      < 2 is swallowed, and a digit group starts where c_{i-1} == 2 at a
      digit that is not a Han run's.

    Returns (P with ``num``, ``let`` and ``han`` rewritten, the digit
    group starts)."""
    valid, ws, let, num = P["valid"], P["ws"], P["let"], P["num"]
    wd = P["uc"] | P["lc"]
    han = P["han"]
    ones = torch.full_like(valid, _ALL1)
    zero = torch.zeros_like(valid)

    def prev_fill1(x, k):
        return ~prevk(~x, k)

    # digit groups: maps (hi, lo) of states 0, 1, 2 (0 = 00, 1 = 01, 2 = 10)
    dig = num & ~han
    maps = [(~num, num), (ones, zero), (~dig, zero)]
    k = 1
    while k < n_total:
        earlier = [(prev_fill1(h, k), prevk(lo, k)) for h, lo in maps]
        (h0, l0), (h1, l1), (h2, l2) = maps
        maps = [((eh & h2) | (el & h1) | (~eh & ~el & h0),
                 (eh & l2) | (el & l1) | (~eh & ~el & l0))
                for eh, el in earlier]
        k *= 2
    at_group = prev_fill1(maps[0][0], 1)  # c_{i-1} == 2
    swallow_num = num & han & ~at_group

    # punctuation bodies
    puk = ~(ws | let | num) & valid
    han_pu = puk & han
    plain = puk & ~wd & ~han
    word_next = nxtk(wd, 1)
    after_sp = prevk(P["sp"], 1)
    body = _affine_fwd(
        (plain & word_next) | (puk & wd) | han_pu,
        (plain & ~word_next) | ((plain & word_next) | han_pu) & after_sp)
    swallow_pu = han_pu & body

    run = han & ~swallow_num & ~swallow_pu
    P = dict(P, num=num & ~run, let=let | run, han=run)
    return P, P["num"] & at_group


def _derive_gpt2_words(P: dict, *, n_total: int) -> torch.Tensor:
    """Word-space port of scanner_ref._piece_starts_gpt2 (see its
    docstring for the derivation). P["fold1"]/P["fold2"] carry the
    CASE-SENSITIVE suffix predicates for this profile."""
    valid, ws, let, num = P["valid"], P["ws"], P["let"], P["num"]
    sp, apo, fold1, fold2 = P["sp"], P["apo"], P["fold1"], P["fold2"]
    pu = ~(ws | let | num) & valid
    at0 = _at0_like(valid)

    def prev1(x):
        return prevk(x, 1)

    def nxt1(x):
        return nxtk(x, 1)

    inv = ~valid
    same = (
        (ws & prev1(ws)) | (let & prev1(let)) | (num & prev1(num))
        | (pu & prev1(pu)) | (inv & prev1(inv))
    )
    newreg = ~same

    nonws_next = nxt1(valid & ~ws)
    last_ws_mid = ws & nonws_next
    b_ws = (ws & newreg) | (last_ws_mid & prev1(ws))
    bind_ws = last_ws_mid & sp

    pu_start = pu & newreg
    ct_ok = apo & pu_start & ~prev1(bind_ws)
    ct2 = ct_ok & fold1
    ct3 = ct_ok & fold2 & ~fold1
    absorbed_letters = prev1(ct2) | prev1(ct3) | prevk(ct3, 2)
    forced_entry = let & (prevk(ct2, 2) | prevk(ct3, 3))

    base = b_ws | (newreg & ~ws & valid) | forced_entry
    sup = (prev1(bind_ws) & ~ws) | absorbed_letters
    starts = base & ~sup & valid
    return (starts & ~at0) | (valid & at0)


def _derive_cl100k_words(P: dict, *, n_total: int) -> torch.Tensor:
    """Word-space port of scanner_ref._piece_starts_cl100k (see its
    docstring for the derivation)."""
    valid, ws, rn, let, num = P["valid"], P["ws"], P["rn"], P["let"], P["num"]
    sp, apo, fold1, fold2 = P["sp"], P["apo"], P["fold1"], P["fold2"]
    pu = ~(ws | let | num) & valid
    at0 = _at0_like(valid)

    def prev1(x):
        return prevk(x, 1)

    def nxt1(x):
        return nxtk(x, 1)

    inv = ~valid
    same = (
        (ws & prev1(ws)) | (let & prev1(let)) | (num & prev1(num))
        | (pu & prev1(pu)) | (inv & prev1(inv))
    )
    newreg = ~same

    b_num = num & stride_marks(num & newreg, num, 3, n_total)

    # C4 [\r\n]* tail absorption: rn-runs directly after punct
    rn_seed = rn & ~prev1(rn) & prev1(pu)
    absorbed = rn & seg_or_fwd(rn_seed, ~rn)

    # ws rules (cf. ws_rules_b in the o200k derivation; rnsl -> rn,
    # wd -> let)
    ws_entry = ws & ~absorbed & (prev1(~ws) | prev1(absorbed) | at0)
    x = rn & ~absorbed
    e_x = seg_or_rev(x, newreg)
    exists_later = nxt1(e_x) & ~nxt1(newreg)
    is_last_rn = x & ~exists_later
    b_after_rn = ws & prev1(is_last_rn)
    in_tail = ws & ~rn & ~absorbed & ~e_x
    at_last = in_tail & nxt1(newreg & valid)
    eligible = at_last & (nxt1(let) | (sp & nxt1(pu)))
    b_ws_split = at_last & prev1(in_tail)
    bound_into = prev1(eligible)
    b_ws = ws_entry | b_after_rn | b_ws_split

    pu_start = pu & newreg
    ct_ok = apo & pu_start & ~bound_into
    ct2 = ct_ok & fold1
    ct3 = ct_ok & fold2 & ~fold1
    ct_any = ct2 | ct3
    absorbed_letters = prev1(ct2) | prev1(ct3) | prevk(ct3, 2)
    forced_entry = let & (prevk(ct2, 2) | prevk(ct3, 3)) & ~absorbed_letters

    bind_pu = pu_start & ~bound_into & ~ct_any & nxt1(let)

    base = b_ws | b_num | (newreg & (let | pu)) | forced_entry
    sup = absorbed | absorbed_letters | bound_into | prev1(bind_pu)
    starts = base & ~sup & valid
    return (starts & ~at0) | (valid & at0)




# ===========================================================================
# Kernel K1 and its plain version
# ===========================================================================

_PROFILE_ID = {"llama4": 0, "nocontract": 1, "cl100k": 2, "gpt2": 3,
               "kimi": 4}


@lru_cache(maxsize=4)
def class_lut(profile: str) -> np.ndarray:
    """(128,) uint32: the kernel's class bits of each ASCII byte value,
    the same member sets _char_masks_planes evaluates."""
    classes, fold = _ascii_class_members()
    sets = dict(classes)
    sets["let"] = classes["uc"] | classes["lc"]
    if profile == "kimi":
        sets["rnsl"] = classes["rn"]
    if profile == "gpt2":
        groups = ("sdmt", "rv", "e", "l")
        for name, letters in zip(("g1", "grv", "ge", "gl"), groups):
            sets[name] = frozenset(ord(ch) for ch in letters)
    elif profile != "nocontract":
        sets["g1"] = fold[_S] | fold[_T] | fold[_M] | fold[_D]
        sets["grv"] = fold[_R] | fold[_V]
        sets["ge"] = fold[_E]
        sets["gl"] = fold[_L]
    lut = np.zeros(128, np.uint32)
    for bit, name in enumerate(CLASS_WORD_BITS):
        for b in sets.get(name, ()):
            lut[b] |= 1 << bit
    # the kernel gives bytes at or beyond nbytes no class; the reference
    # gives them byte 0's, so byte 0 must have none
    if lut[0]:
        raise ValueError("byte 0 belongs to a class; the kernel needs none")
    return lut


def piece_starts_bits_plain(by: torch.Tensor, nbytes: torch.Tensor, *,
                            profile: str = "llama4") -> torch.Tensor:
    """Plain torch version of K1: (B, N) bytes -> (B, N/32) int32 words."""
    contractions = profile != "nocontract"
    P = _char_masks_planes(by, nbytes, contractions=contractions,
                           profile=profile)
    return derive_starts_words(P, contractions=contractions,
                               n_total=by.shape[-1], profile=profile)


@lru_cache(maxsize=None)
def _k1_library():
    from .._build import cuda_library

    lib = cuda_library("piece_starts")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.td_piece_starts.argtypes = [
        vp, vp, i, i, i, ctypes.POINTER(ctypes.c_uint32), vp, vp, vp]
    lib.td_piece_starts.restype = i
    lib.td_piece_starts_cp.argtypes = [vp, vp, i, i, i, vp, vp, vp, vp]
    lib.td_piece_starts_cp.restype = i
    lib.td_piece_starts_words.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    lib.td_piece_starts_words.restype = i
    lib.td_piece_starts_scratch_words.argtypes = [i]
    lib.td_piece_starts_scratch_words.restype = ctypes.c_longlong
    lib.td_piece_starts_passes.argtypes = [i, i]
    lib.td_piece_starts_passes.restype = i
    lib.td_piece_starts_blocks.argtypes = [i, i, i]
    lib.td_piece_starts_blocks.restype = i
    lib.td_piece_starts_cp_rows.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    lib.td_piece_starts_cp_rows.restype = i
    return lib


def starts_passes(profile: str, n: int) -> int:
    """Passes K1 makes over a window's planes (data independent)."""
    return _k1_library().td_piece_starts_passes(_PROFILE_ID[profile], n)


_K1_ENTRIES = {"bytes": 0, "codepoints": 1, "words": 2}


def starts_blocks_per_window(entry: str, batch: int, n: int) -> int:
    """Thread blocks (segments) per window K1's ``entry`` ("bytes",
    "codepoints" or "words") launches for ``batch`` windows of ``n`` chars
    on the current card (a batch of more windows than the card holds
    blocks runs in groups, one block per window); 0 if the card cannot be
    read."""
    return _k1_library().td_piece_starts_blocks(_K1_ENTRIES[entry], batch, n)


def _launch_k1(by: torch.Tensor, nbytes: torch.Tensor, profile: str):
    lib = _k1_library()
    B, N = by.shape
    words = lib.td_piece_starts_scratch_words(N)
    scratch = torch.empty(B * words, dtype=torch.int32, device=by.device)
    out = torch.empty((B, N // 32), dtype=torch.int32, device=by.device)
    lut = (ctypes.c_uint32 * 128)(*class_lut(profile).tolist())
    with torch.cuda.device(by.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.td_piece_starts(
            by.data_ptr(), nbytes.data_ptr(), B, N, _PROFILE_ID[profile],
            lut, scratch.data_ptr(), out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"piece_starts kernel launch failed: CUDA error {rc}")
    piece_starts_bits.launches += 1
    return out


def piece_starts_bits(by: torch.Tensor, nbytes: torch.Tensor, *,
                      profile: str = "llama4",
                      packed_out: bool = True) -> torch.Tensor:
    """Piece-start flags of a batch of ASCII windows.

    ``by`` (B, N) uint8 windows (bytes at or beyond ``nbytes`` may be
    anything), ``nbytes`` (B,) int32 on the same device; N a multiple of
    1024. Returns (B, N/32) int32 plane-major words (uint32 bits) when
    ``packed_out``, else (B, N) bool. The caller guarantees every byte
    below ``nbytes`` is ASCII. CUDA tensors run kernel K1; CPU tensors
    the plain version."""
    if profile not in _PROFILE_ID:
        raise NotImplementedError(profile)
    if by.dim() != 2 or by.dtype != torch.uint8 or not by.is_contiguous():
        raise ValueError("by must be a contiguous (B, N) uint8 tensor")
    B, N = by.shape
    if N % 1024:
        raise ValueError(f"window length {N} is not a multiple of 1024")
    if (nbytes.shape != (B,) or nbytes.dtype != torch.int32
            or nbytes.device != by.device or not nbytes.is_contiguous()):
        raise ValueError("nbytes must be a contiguous (B,) int32 tensor "
                         "on the windows' device")
    if by.is_cuda:
        words = _launch_k1(by, nbytes, profile)
    elif by.device.type == "cpu":
        words = piece_starts_bits_plain(by, nbytes, profile=profile)
    else:
        raise ValueError(f"unsupported device {by.device}")
    return words if packed_out else unpack_mask(words)


piece_starts_bits.launches = 0


# ===========================================================================
# General text: codepoints -> char-level starts (K1's codepoint entry)
# ===========================================================================


@lru_cache(maxsize=None)
def _class_words(profile: str, device: str) -> torch.Tensor:
    """``char_class_words(profile)`` on ``device``: int32 on the CPU (for
    the plain version), int16 holding the uint16 bits on a card."""
    w = char_class_words(profile)
    if device == "cpu":
        return torch.from_numpy(w.astype(np.int32))
    return torch.from_numpy(w.view(np.int16).copy()).to(device)


def _class_word_masks(cls: torch.Tensor, m: torch.Tensor):
    """Packed (B, N/32) class words from per-char class words ``cls``
    (bits as ``char_class_words``) of the chars below ``m``, and the
    contraction predicates from the fold-letter groups of the next one and
    two chars."""
    n = cls.shape[-1]
    valid = torch.arange(n, device=cls.device) < m.to(torch.int64)[:, None]
    cls = torch.where(valid, cls, 0)
    P = {name: pack_mask(((cls >> i) & 1).to(torch.bool))
         for i, name in enumerate(CLASS_WORD_BITS)}
    P["valid"] = pack_mask(valid)
    P["fold1"] = nxtk(P.pop("g1"), 1)
    grv, ge, gl = P.pop("grv"), P.pop("ge"), P.pop("gl")
    P["fold2"] = (nxtk(grv, 1) & nxtk(ge, 2)) | (nxtk(gl, 1) & nxtk(gl, 2))
    return P


def _table_classes(table: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    """``table[cp]`` as int32; a codepoint outside [0, 0x10FFFF] has
    none."""
    known = (cp >= 0) & (cp <= N_CP - 1)
    return torch.where(known, table[cp.clamp(0, N_CP - 1).to(torch.int64)],
                       0).to(torch.int32)


def _char_masks_words(cp: torch.Tensor, m: torch.Tensor, profile: str):
    """Packed (B, N/32) class words of codepoint windows: every class bit
    of ``char_class_words`` at the chars below ``m`` (a codepoint outside
    [0, 0x10FFFF] has none), and the contraction predicates."""
    table = _class_words(profile, "cpu").to(cp.device)
    return _class_word_masks(_table_classes(table, cp), m)


def piece_starts_chars_plain(cp: torch.Tensor, m: torch.Tensor, *,
                             profile: str = "llama4") -> torch.Tensor:
    """Plain torch version of K1's codepoint entry: (B, N) int32
    codepoints -> (B, N/32) int32 plane-major start words."""
    contractions = profile != "nocontract"
    return derive_starts_words(_char_masks_words(cp, m, profile),
                               contractions=contractions,
                               n_total=cp.shape[-1], profile=profile)


def _launch_k1_cp(cp: torch.Tensor, m: torch.Tensor, profile: str):
    lib = _k1_library()
    B, N = cp.shape
    dev = cp.device
    table = _class_words(profile, str(dev))
    words = lib.td_piece_starts_scratch_words(N)
    scratch = torch.empty(B * words, dtype=torch.int32, device=dev)
    out = torch.empty((B, N // 32), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.td_piece_starts_cp(
            cp.data_ptr(), m.data_ptr(), B, N, _PROFILE_ID[profile],
            table.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream)
    if rc:
        raise RuntimeError(
            f"piece_starts_cp kernel launch failed: CUDA error {rc}")
    piece_starts_chars.launches += 1
    return out


# K1's row entry takes rows of at most this many chars (N % 32 == 0); the
# window entries take N % 1024 == 0.
ROW_MAX_CHARS = 4096


def _launch_k1_rows(cp: torch.Tensor, m: torch.Tensor, profile: str):
    lib = _k1_library()
    B, N = cp.shape
    dev = cp.device
    table = _class_words(profile, str(dev))
    out = torch.empty((B, N // 32), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.td_piece_starts_cp_rows(
            cp.data_ptr(), m.data_ptr(), B, N, _PROFILE_ID[profile],
            table.data_ptr(), out.data_ptr(), stream)
    if rc:
        raise RuntimeError(
            f"piece_starts_cp_rows kernel launch failed: CUDA error {rc}")
    piece_starts_rows.launches += 1
    return out


def piece_starts_rows(cp: torch.Tensor, m: torch.Tensor, *,
                      profile: str = "llama4") -> torch.Tensor:
    """K1's row entry: (B, N) int32 codepoint rows of N <= ROW_MAX_CHARS
    chars (N % 32 == 0), ``m`` (B,) int32 char counts -> (B, N/32) int32
    plane-major start words, as ``piece_starts_chars(packed_out=True)``
    returns them. CUDA tensors run one block per row with the row's
    planes in shared memory; CPU tensors the plain version.
    ``piece_starts_chars`` takes this entry for such rows."""
    if profile not in _PROFILE_ID:
        raise NotImplementedError(profile)
    if cp.dim() != 2 or cp.dtype != torch.int32 or not cp.is_contiguous():
        raise ValueError("cp must be a contiguous (B, N) int32 tensor")
    B, N = cp.shape
    if N % 32 or not 32 <= N <= ROW_MAX_CHARS:
        raise ValueError(f"row length {N} is not a multiple of 32 in "
                         f"[32, {ROW_MAX_CHARS}]")
    if (m.shape != (B,) or m.dtype != torch.int32 or m.device != cp.device
            or not m.is_contiguous()):
        raise ValueError("m must be a contiguous (B,) int32 tensor on the "
                         "rows' device")
    if cp.is_cuda:
        return _launch_k1_rows(cp, m, profile)
    if cp.device.type != "cpu":
        raise ValueError(f"unsupported device {cp.device}")
    return piece_starts_chars_plain(cp, m, profile=profile)


piece_starts_rows.launches = 0


def piece_starts_chars(cp: torch.Tensor, m, *, profile: str = "llama4",
                       packed_out: bool = False, hot_cps=None,
                       u_cap: int | None = None):
    """Char-level piece-start flags of codepoint windows (any text).

    ``cp`` (N,) or (B, N) int32 codepoints (anything at or beyond ``m``),
    ``m`` a scalar or (B,) int32 char counts on the same device; N a
    multiple of 32 up to ROW_MAX_CHARS, else of 1024. Returns bool flags
    of ``cp``'s shape, or with ``packed_out`` the (B, N/32) int32
    plane-major words. CUDA tensors run kernel K1: rows of at most
    ROW_MAX_CHARS chars its row entry (``piece_starts_rows``), longer
    windows its codepoint entry; CPU tensors the plain version.

    With ``hot_cps`` (and ``u_cap``) the classes come from
    ``class_lookup_hot`` over ``char_class_words(profile)`` and K1 runs
    its class-word entry; the return is then ``(starts, cls_overflow)``,
    cls_overflow (B,) bool set where a window's non-hot chars exceed
    ``u_cap`` (its flags are then wrong: the caller must fall back)."""
    if profile not in _PROFILE_ID:
        raise NotImplementedError(profile)
    one = cp.dim() == 1
    c2 = cp[None] if one else cp
    if c2.dim() != 2 or c2.dtype != torch.int32 or not c2.is_contiguous():
        raise ValueError("cp must be a contiguous (N,) or (B, N) int32 tensor")
    B, N = c2.shape
    if N % (32 if N <= ROW_MAX_CHARS else 1024) or N == 0:
        raise ValueError(f"window length {N} is not a multiple of 32 up to "
                         f"{ROW_MAX_CHARS}, or of 1024")
    m2 = torch.as_tensor(m, device=cp.device).to(torch.int32).reshape(-1)
    if m2.shape != (B,):
        raise ValueError(f"m must hold {B} char counts")
    m2 = m2.contiguous()
    if cp.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {cp.device}")
    ovf = None
    if hot_cps is not None:
        if u_cap is None:
            raise ValueError("hot_cps needs u_cap")
        cls, ovf = class_lookup_hot(c2, m2, hot_cps=hot_cps, u_cap=u_cap,
                                    table=char_class_words(profile))
        words = piece_starts_words(cls, m2, profile=profile)
    elif N <= ROW_MAX_CHARS:
        words = piece_starts_rows(c2, m2, profile=profile)
    elif cp.is_cuda:
        words = _launch_k1_cp(c2, m2, profile)
    else:
        words = piece_starts_chars_plain(c2, m2, profile=profile)
    if packed_out:
        out = words
    else:
        flags = unpack_mask(words)
        out = flags[0] if one else flags
    return out if ovf is None else (out, ovf)


piece_starts_chars.launches = 0


# ===========================================================================
# Hot-codepoint class lookup and K1's class-word entry
# ===========================================================================


_DEVICE_TABLES: dict = {}


def _device_table(table: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``table`` as an int32 tensor on ``dev``, kept per table and
    device (the tables are the cached arrays of ``unicode_tables``)."""
    key = (id(table), str(dev))
    hit = _DEVICE_TABLES.get(key)
    if hit is None or hit[0] is not table:
        t = torch.from_numpy(np.asarray(table).astype(np.int32)).to(dev)
        hit = _DEVICE_TABLES[key] = (table, t)
    return hit[1]


@lru_cache(maxsize=8)
def _hot_values(hot_cps: tuple, n_table: int, device: str) -> torch.Tensor:
    """The distinct hot codepoints, sorted, as int32 on ``device``."""
    hv = np.unique(np.asarray(hot_cps, np.int64))
    if len(hv) and (hv[0] < 0 or hv[-1] >= n_table):
        raise ValueError("hot codepoints must index the class table")
    return torch.from_numpy(hv.astype(np.int32)).to(device)


def class_lookup_hot(cp: torch.Tensor, m: torch.Tensor, *, hot_cps,
                     u_cap: int, table: np.ndarray | None = None):
    """Per-char class of a (B, C) codepoint batch with hot-codepoint
    pre-classification: the JAX ``bitplane.class_lookup_hot``.

    Chars equal to one of ``hot_cps`` take ``table[v]`` by compare; the
    other chars below ``m`` are compacted to a (B, u_cap) prefix (kernel
    K5+K6), looked up in ``table`` there, and put back (K7+K8). ``table``
    is the (0x110000,) class table, by default the class bits of
    ``unicode_tables.get_tables()``; K1's class-word entry wants
    ``char_class_words(profile)``. Returns (cls (B, C) int32, overflow
    (B,) bool): overflow is set where a window's non-hot chars exceed
    ``u_cap``, and that window's classes are then wrong."""
    from .compact import compact_record, expand_route  # compact imports us

    if table is None:
        table = get_tables()[0]
    cp = cp.contiguous()
    dev = cp.device
    tab = _device_table(table, dev)
    hot_v = _hot_values(tuple(int(v) for v in hot_cps), len(table), str(dev))
    B, C = cp.shape
    valid = torch.arange(C, device=dev) < m.to(torch.int64)[:, None]
    if len(hot_v):
        pos = torch.searchsorted(hot_v, cp).clamp(max=len(hot_v) - 1)
        hot = hot_v[pos] == cp
        cls_hot = tab[hot_v.to(torch.int64)][pos]
    else:
        hot = torch.zeros_like(valid)
        cls_hot = torch.zeros_like(cp)
    unknown = valid & ~hot
    (cp_u,), n_unknown, route = compact_record([cp], unknown, cap=u_cap)
    cls_back = expand_route(_table_classes(tab, cp_u), route, unknown)
    return torch.where(hot, cls_hot, cls_back), n_unknown > u_cap


def piece_starts_words_plain(words: torch.Tensor, m: torch.Tensor, *,
                             profile: str = "llama4") -> torch.Tensor:
    """Plain torch version of K1's class-word entry: (B, N) int32 class
    words -> (B, N/32) int32 plane-major start words."""
    contractions = profile != "nocontract"
    return derive_starts_words(_class_word_masks(words, m),
                               contractions=contractions,
                               n_total=words.shape[-1], profile=profile)


def _launch_k1_words(words: torch.Tensor, m: torch.Tensor, profile: str):
    lib = _k1_library()
    B, N = words.shape
    dev = words.device
    scratch = torch.empty(B * lib.td_piece_starts_scratch_words(N),
                          dtype=torch.int32, device=dev)
    out = torch.empty((B, N // 32), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.td_piece_starts_words(
            words.data_ptr(), m.data_ptr(), B, N, _PROFILE_ID[profile],
            scratch.data_ptr(), out.data_ptr(), stream)
    if rc:
        raise RuntimeError(
            f"piece_starts_words kernel launch failed: CUDA error {rc}")
    piece_starts_words.launches += 1
    return out


def piece_starts_words(words: torch.Tensor, m: torch.Tensor, *,
                       profile: str = "llama4") -> torch.Tensor:
    """Plane-major (B, N/32) int32 start words of windows given as (B, N)
    int32 per-char class words (bits as ``char_class_words``; anything at
    or beyond the (B,) int32 char counts ``m``). N a multiple of 1024.
    CUDA tensors run K1's class-word entry; CPU tensors the plain
    version."""
    if profile not in _PROFILE_ID:
        raise NotImplementedError(profile)
    if (words.dim() != 2 or words.dtype != torch.int32
            or not words.is_contiguous()):
        raise ValueError("words must be a contiguous (B, N) int32 tensor")
    B, N = words.shape
    if N % 1024:
        raise ValueError(f"window length {N} is not a multiple of 1024")
    if (m.shape != (B,) or m.dtype != torch.int32 or m.device != words.device
            or not m.is_contiguous()):
        raise ValueError("m must be a contiguous (B,) int32 tensor on the "
                         "words' device")
    if words.is_cuda:
        return _launch_k1_words(words, m, profile)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return piece_starts_words_plain(words, m, profile=profile)


piece_starts_words.launches = 0
