"""UTF-8 decode (kernel K9) and the char <-> byte mappings of a window.

Counterparts of the JAX package's ``ops/pretokenize`` (``utf8_decode``,
``starts_to_bytes``) and ``ops/pallas_scan`` (``utf8_decode_block``):

* ``utf8_decode_block`` gives, per byte, the codepoint assembled from it
  and its next three bytes and the lead-byte flag. CUDA tensors run kernel
  K9 (``csrc/utf8.cu``); CPU tensors the plain version below.
* ``utf8_decode`` compacts those to one codepoint per char: K9, a
  ``torch.cumsum`` for the char index of every byte (``_char_index``),
  and kernel K4
  (``compact.compact_by_mask``) for the compaction the JAX function does
  with two scatters.
* ``starts_to_bytes`` maps char-level piece-start flags to byte flags.
* ``utf8_decode_tiles`` and ``expand_starts_replay`` are the batched
  general pipeline's decode and its inverse (the JAX functions of those
  names): the codepoints of the lead bytes compacted to a dense (B, c_cap)
  prefix by kernel K5+K6 (``compact.compact_record``), with the route that
  K7+K8 (``compact.expand_route``) follows to put char-level piece-start
  flags back on the lead bytes.

* ``utf8_decode_ascii`` and ``utf8_decode_sorted`` are the same decode
  in plain torch for ASCII windows (no compaction) and with the
  compaction done by one ``torch.sort``.
* The char-per-element scans, plain torch on any device: ``match_lengths``
  (the JAX ``match_lengths_jax``, with ``_match_lengths_cl100k`` and
  ``_match_lengths_gpt2`` for its ``_jax`` helpers), ``chain_starts``
  (pointer doubling), and the boundary-local piece starts
  ``piece_starts`` (the JAX ``piece_starts_jax``; ``_piece_starts_gpt2``
  and ``_piece_starts_cl100k`` for ``_piece_starts_gpt2_jax`` and
  ``_piece_starts_cl100k_jax``). They take the two-level class table
  ``unicode_tables.get_two_level_tables()``, as the JAX functions do.
* ``compact_pieces``, ``scan_bytes`` and ``compute_starts`` (which on a
  card launches kernel K1, ``bitplane.piece_starts_chars``).

Every function takes a (B, N) batch of windows with (B,) int32 lengths
or counts, or one (N,) window with a scalar, as the JAX functions do
(which the reference vmaps over a batch), and scans along the last axis;
the general pipeline's functions take batches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..unicode_tables import LC, LETTER, NUM, RN, UC, WS, get_tables
from .bitplane import piece_starts_chars
from .compact import (
    _check, _on, _require, compact_by_mask, compact_record, expand_route,
)

MAX_CP = 0x10FFFF


def _batched(data: torch.Tensor, nbytes, column: bool = False):
    """(B, N) view of ``data``, its lengths or counts ``nbytes`` on its
    device, and whether the caller passed one row. The lengths are (B,)
    int32, or with ``column`` a (B, 1) int64 column that broadcasts
    along the rows."""
    one = data.dim() == 1
    d = data[None] if one else data
    nb = torch.as_tensor(nbytes, device=data.device)
    if column:
        return d, nb.to(torch.int64).reshape(-1, 1), one
    return d, nb.to(torch.int32).reshape(-1), one


# ===========================================================================
# K9: per-byte decode
# ===========================================================================


def _next_bytes(b: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = b[..., i + k], 0 past the end of the row."""
    pad = torch.zeros(b.shape[:-1] + (k,), dtype=b.dtype, device=b.device)
    return torch.cat([b[..., k:], pad], dim=-1)


def utf8_decode_block_plain(data: torch.Tensor):
    """Plain torch version of K9: (..., N) uint8 -> (cp_at, is_start),
    both (..., N) int32 (the jnp branch of the JAX ``utf8_decode``)."""
    b = data.to(torch.int32)
    b1, b2, b3 = (_next_bytes(b, k) for k in (1, 2, 3))
    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = (((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
           | (b3 & 0x3F))
    cp_at = torch.where(b < 0x80, b, torch.where(
        b < 0xE0, cp2, torch.where(b < 0xF0, cp3, cp4)))
    is_start = ((b & 0xC0) != 0x80).to(torch.int32)
    return torch.clamp(cp_at, 0, MAX_CP), is_start


@lru_cache(maxsize=None)
def _k9_library():
    from .._build import cuda_library

    lib = cuda_library("utf8")
    vp = ctypes.c_void_p
    lib.td_utf8_decode_block.argtypes = [vp, ctypes.c_int, ctypes.c_longlong,
                                         vp, vp, vp]
    lib.td_utf8_decode_block.restype = ctypes.c_int
    return lib


def _launch_k9(data: torch.Tensor):
    lib = _k9_library()
    B, N = data.shape
    cp_at = torch.empty((B, N), dtype=torch.int32, device=data.device)
    is_start = torch.empty((B, N), dtype=torch.int32, device=data.device)
    with _on(data.device) as stream:
        rc = lib.td_utf8_decode_block(data.data_ptr(), B, N,
                                      cp_at.data_ptr(), is_start.data_ptr(),
                                      stream)
    _check(rc, "utf8_decode_block")
    utf8_decode_block.launches += 1
    return cp_at, is_start


def utf8_decode_block(data: torch.Tensor):
    """Per-byte (codepoint at the byte, lead flag) of (N,) or (B, N) uint8
    windows, both int32 of the same shape. Each row decodes on its own:
    neighbours past its end read as 0. Any N (the Pallas kernel needed
    N % 8192 == 0). CUDA tensors run kernel K9; CPU tensors the plain
    version."""
    if data.dim() not in (1, 2):
        raise ValueError("data must be (N,) or (B, N)")
    d2 = data if data.dim() == 2 else data[None]
    _require(d2, "data", d2.shape, torch.uint8, data.device)
    if data.is_cuda:
        out = _launch_k9(d2)
    elif data.device.type == "cpu":
        out = utf8_decode_block_plain(d2)
    else:
        raise ValueError(f"unsupported device {data.device}")
    return out if data.dim() == 2 else tuple(o[0] for o in out)


utf8_decode_block.launches = 0


# ===========================================================================
# Compaction to chars and the byte mapping
# ===========================================================================


def _char_index(is_start: torch.Tensor) -> torch.Tensor:
    """int32 inclusive cumsum of (B, N) bool flags along each row, minus
    one. On a card torch scans the rows of a (B, N) tensor with B > 1 by
    a kernel made for many short rows: ~0.5 ms for a batch of 1 MB
    windows (H100). So windows of more than 4096 bytes are scanned as one
    flat array, and each row's start taken off."""
    B, N = is_start.shape
    if B == 1 or N <= 4096:
        return torch.cumsum(is_start, dim=1, dtype=torch.int32) - 1
    flat = torch.cumsum(is_start.reshape(-1), dim=0,
                        dtype=torch.int32).view(B, N)
    before = torch.zeros((B, 1), dtype=torch.int32, device=flat.device)
    before[1:] = flat[:-1, -1:]
    return flat - (before + 1)


def utf8_decode(data: torch.Tensor, nbytes):
    """Decode UTF-8 windows to compacted codepoints.

    ``data`` (N,) or (B, N) uint8 (anything at or beyond ``nbytes``),
    ``nbytes`` a scalar or (B,) int32. Returns (cp int32 0-padded,
    char_of_byte int32 = cumsum(lead) - 1, byte_of_char int32 padded with
    nbytes, n_chars int32 (0 when nbytes == 0)), shapes as the input's:
    the contract of the JAX ``utf8_decode``."""
    d, nb, one = _batched(data, nbytes)
    B, N = d.shape
    cp_at, lead = utf8_decode_block(d)
    idx = torch.arange(N, dtype=torch.int32, device=d.device)
    is_start = (lead != 0) & (idx < nb[:, None])
    char_of_byte = _char_index(is_start)
    n_chars = torch.where(nb > 0, torch.clamp(char_of_byte[:, -1] + 1, min=0),
                          0).to(torch.int32)
    cp, boc = compact_by_mask(
        [cp_at, idx.expand(B, N).contiguous()], is_start, fill=0)
    byte_of_char = torch.where(idx < n_chars[:, None], boc, nb[:, None])
    out = (cp, char_of_byte, byte_of_char, n_chars)
    return tuple(o[0] for o in out) if one else out


def starts_to_bytes(starts_char: torch.Tensor, char_of_byte: torch.Tensor,
                    data: torch.Tensor, nbytes) -> torch.Tensor:
    """Byte-level piece-start flags: byte j starts a piece iff it is a
    lead byte below ``nbytes`` and its char's flag is set."""
    d, nb, one = _batched(data, nbytes)
    sc = starts_char if not one else starts_char[None]
    cob = char_of_byte if not one else char_of_byte[None]
    N = d.shape[1]
    idx = torch.arange(N, device=d.device)
    is_lead = ((d.to(torch.int32) & 0xC0) != 0x80) & (idx < nb[:, None])
    out = torch.gather(sc, 1, cob.clamp(0, N - 1).to(torch.int64)) & is_lead
    return out[0] if one else out


# ===========================================================================
# The batched general pipeline's decode and its inverse
# ===========================================================================


def utf8_codepoints_at_leads(data: torch.Tensor, nbytes: torch.Tensor):
    """Per-byte codepoint (valid at lead bytes; K9) and the (B, N) bool
    mask of the lead bytes below ``nbytes``: the JAX
    ``_utf8_codepoints_at_leads``."""
    cp_at, is_start = utf8_decode_block(data)
    idx = torch.arange(data.shape[1], dtype=torch.int32, device=data.device)
    return cp_at, (is_start != 0) & (idx < nbytes[:, None])


def utf8_decode_tiles(data: torch.Tensor, nbytes: torch.Tensor, *,
                      c_cap: int | None = None):
    """General UTF-8 decode of a window batch with its route.

    ``data`` (B, N) uint8, ``nbytes`` (B,) int32. Returns (cp (B, c_cap)
    int32, the codepoints of the lead bytes in order and 0 at and beyond
    ``n_chars``; lead (B, N) bool; n_chars (B,) int32, which exceeds
    ``c_cap`` when the window has more chars; route, for
    ``expand_starts_replay``): the JAX ``utf8_decode_tiles``."""
    d, nb, _ = _batched(data, nbytes)
    C = c_cap or d.shape[1]
    cp_at, lead = utf8_codepoints_at_leads(d, nb)
    (cp,), n_chars, route = compact_record([cp_at], lead, cap=C, fill=0)
    return cp, lead, n_chars, route


def expand_starts_replay(starts_char: torch.Tensor, lead: torch.Tensor,
                         route: torch.Tensor) -> torch.Tensor:
    """Byte-level piece-start flags from char-level ones: byte j's flag is
    ``lead[j] & starts_char[rank(j)]`` (0 for a char past ``c_cap``), with
    ``rank`` and ``route`` from ``utf8_decode_tiles``."""
    flags = expand_route(starts_char.to(torch.int32).contiguous(), route,
                         lead)
    return flags != 0


# ===========================================================================
# The sorted and ASCII decodes
# ===========================================================================


def utf8_decode_ascii(data: torch.Tensor, nbytes):
    """``utf8_decode`` of windows whose bytes below ``nbytes`` are all
    ASCII (the caller checks): chars are bytes, so nothing is compacted.
    Same shapes and outputs as ``utf8_decode`` on such windows."""
    d, nb, one = _batched(data, nbytes)
    idx = torch.arange(d.shape[1], dtype=torch.int32, device=d.device)
    nbc = nb[:, None]
    valid = idx < nbc
    cp = torch.where(valid, d.to(torch.int32), 0)
    char_of_byte = torch.where(nbc > 0, torch.minimum(idx, nbc - 1), -1)
    byte_of_char = torch.where(valid, idx, nbc)
    n_chars = torch.clamp(nb, min=0)
    out = (cp, char_of_byte.to(torch.int32), byte_of_char.to(torch.int32),
           n_chars)
    return tuple(o[0] for o in out) if one else out


def utf8_decode_sorted(data: torch.Tensor, nbytes):
    """``utf8_decode`` in plain torch with the codepoint compaction done
    by one sort: the key is a byte's index at a lead byte and N + index
    elsewhere (unique, so the first ``n_chars`` sorted keys are the lead
    bytes in order), and the codepoints follow the sort's permutation."""
    d, nb, one = _batched(data, nbytes)
    N = d.shape[1]
    idx = torch.arange(N, dtype=torch.int32, device=d.device)
    cp_at, lead = utf8_decode_block_plain(d)
    is_start = (lead != 0) & (idx < nb[:, None])
    char_of_byte = torch.cumsum(is_start, dim=1, dtype=torch.int32) - 1
    n_chars = torch.where(nb > 0, torch.clamp(char_of_byte[:, -1] + 1, min=0),
                          0).to(torch.int32)
    ks, perm = torch.sort(torch.where(is_start, idx, N + idx), dim=1)
    live = idx < n_chars[:, None]
    cp = torch.where(live, torch.gather(cp_at, 1, perm), 0)
    byte_of_char = torch.where(live, ks, nb[:, None])
    out = (cp, char_of_byte, byte_of_char, n_chars)
    return tuple(o[0] for o in out) if one else out


# ===========================================================================
# Char-per-element scans: helpers
# ===========================================================================
#
# Each function below takes (N,) or (B, N) with a scalar or (B,) count
# and scans along the last axis; ``idx`` is the (N,) int64 position and
# ``mI`` the (B, 1) int64 count, so both broadcast against (B, N).

# contraction fold-letter ids (scanner_ref._FOLD_ORDER)
_S, _T, _R, _E, _V, _M, _L, _D = range(8)


def _rcummin(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative minimum along the last axis."""
    return torch.flip(torch.cummin(torch.flip(x, [-1]), dim=-1).values, [-1])


def _runlen(mask: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """r[i] = consecutive True at and after i."""
    return _rcummin(torch.where(mask, n, idx)) - idx


def _prevpos(mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p[i] = largest j <= i with mask[j], else -1."""
    return torch.cummax(torch.where(mask, idx, -1), dim=-1).values


def _nextpos_m(mask: torch.Tensor, idx: torch.Tensor, m) -> torch.Tensor:
    """p[i] = smallest j >= i with mask[j], else m (the valid length)."""
    return _rcummin(torch.where(mask, idx, m))


def _fill(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """(..., k) block of ``fill`` (a scalar, or a (B, 1) tensor)."""
    shape = a.shape[:-1] + (k,)
    if isinstance(fill, torch.Tensor):
        return fill.to(a.dtype).expand(shape)
    return torch.full(shape, fill, dtype=a.dtype, device=a.device)


def _shr(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """out[..., i] = a[..., i - k], ``fill`` for i < k."""
    if k == 0:
        return a
    n = a.shape[-1]
    if k >= n:
        return _fill(a, n, fill).clone()
    return torch.cat([_fill(a, k, fill), a[..., : n - k]], dim=-1)


def _shl(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """out[..., i] = a[..., i + k], ``fill`` past the end."""
    if k == 0:
        return a
    n = a.shape[-1]
    if k >= n:
        return _fill(a, n, fill).clone()
    return torch.cat([a[..., k:], _fill(a, k, fill)], dim=-1)


def _take(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """a[..., clip(j, 0, N - 1)] along the last axis."""
    return torch.gather(a, -1, j.clamp(0, a.shape[-1] - 1))


def _cls_lookup(cp: torch.Tensor, page_ids, pages) -> torch.Tensor:
    """Class byte of each codepoint, int64, from the two-level table
    (numpy arrays or tensors): one gather of the flat table that the pages
    expand to (the JAX function's 16-wide row gather with a lane select
    is a TPU device; the outputs are equal)."""
    dev = cp.device
    pid, pg = (x.to(dev) if isinstance(x, torch.Tensor)
               else torch.from_numpy(np.asarray(x).astype(np.int64)).to(dev)
               for x in (page_ids, pages))
    flat = pg[pid.to(torch.int64)].reshape(-1)
    return flat[cp.to(torch.int64).clamp(0, flat.shape[0] - 1)].to(
        torch.int64)


@lru_cache(maxsize=None)
def _fold_cps(letter_id: int) -> tuple[int, ...]:
    from ..scanner_ref import _FOLD_ORDER

    return tuple(int(c) for c in get_tables()[1][_FOLD_ORDER[letter_id]])


def _fold_is(cp: torch.Tensor, letter_id: int) -> torch.Tensor:
    """cp case-folds to the given contraction letter (a handful of
    compares against the fold set's codepoints)."""
    hits = torch.zeros(cp.shape, dtype=torch.bool, device=cp.device)
    for c in _fold_cps(letter_id):
        hits |= cp == c
    return hits


def _ffill_at_j(entry: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Value of ``val`` at the latest entry position <= i, -1 if none
    (the JAX function packs the value into the cummax key; the latest
    position's gather gives the same)."""
    idx = torch.arange(entry.shape[-1], device=entry.device)
    p = _prevpos(entry, idx)
    return torch.where(p >= 0, _take(val, p), -1)


def _ffill_bool_at_j(sample: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """X at the latest position j <= i with sample[j], else False."""
    idx = torch.arange(sample.shape[-1], device=sample.device)
    p = _prevpos(sample, idx)
    return (p >= 0) & _take(X, p)


def _ct_chain_accept(ct2, ct3, exact2, exact3) -> torch.Tensor:
    """Acceptance flags of scanner_ref._piece_starts_llama's sequential
    contraction-candidate walk: a candidate linked to the one before it
    (starting exactly at its suffix end) alternates accept/reject from the
    first member of its chain (see the JAX function's docstring)."""
    cand = ct2 | ct3
    link_in = cand & (
        (_shr(ct2 & exact2, 2, False) & ~_shr(cand, 1, False))
        | (_shr(ct3 & exact3, 3, False) & ~_shr(cand, 1, False)
           & ~_shr(cand, 2, False)))
    cidx = torch.cumsum(cand.to(torch.int64), dim=-1)
    chain_start = cand & ~link_in
    start_cidx = torch.cummax(torch.where(chain_start, cidx, -1),
                              dim=-1).values
    rej = cand & (((cidx - start_cidx) & 1) == 1)
    return cand & ~rej


def _next_cps(cp: torch.Tensor, idx: torch.Tensor, mI: torch.Tensor):
    """The next and the one-after-next codepoint, 0 at and past m."""
    cp1 = torch.where(idx + 1 < mI, _shl(cp, 1, 0), 0)
    cp2 = torch.where(idx + 2 < mI, _shl(cp, 2, 0), 0)
    return cp1, cp2


def _fold_one_two(cp1, cp2):
    """'s 't 'm 'd and 're 've 'll under (?i:...) folds."""
    one = (_fold_is(cp1, _S) | _fold_is(cp1, _T) | _fold_is(cp1, _M)
           | _fold_is(cp1, _D))
    two = ((_fold_is(cp1, _R) & _fold_is(cp2, _E))
           | (_fold_is(cp1, _V) & _fold_is(cp2, _E))
           | (_fold_is(cp1, _L) & _fold_is(cp2, _L)))
    return one, two


def _first_flag(starts: torch.Tensor, mI: torch.Tensor, one: bool):
    """starts[..., 0] = m > 0, in the caller's shape."""
    starts[:, 0] = mI[:, 0] > 0
    return starts[0] if one else starts


def _newreg(K: torch.Tensor) -> torch.Tensor:
    """True where the region code changes (and at 0)."""
    first = torch.ones(K.shape[:-1] + (1,), dtype=torch.bool,
                       device=K.device)
    return torch.cat([first, K[..., 1:] != K[..., :-1]], dim=-1)


# ===========================================================================
# Match lengths and the pointer-doubling chain
# ===========================================================================


def match_lengths(cp: torch.Tensor, m, page_ids, pages, *,
                  contractions: bool = True,
                  profile: str | None = None) -> torch.Tensor:
    """Per-char match length, int32 of ``cp``'s shape, >= 1 everywhere
    (the JAX ``match_lengths_jax``). Any profile other than "cl100k",
    "gpt2" and "nocontract" runs the llama4 logic with contractions, but
    "kimi" raises NotImplementedError: the two-level class table has no
    Han (``bitplane.piece_starts_chars`` serves it)."""
    if profile is None:
        profile = "llama4" if contractions else "nocontract"
    if profile == "kimi":
        raise NotImplementedError(
            "the char form has no Han table for the kimi profile; use "
            "bitplane.piece_starts_chars")
    if profile == "cl100k":
        return _match_lengths_cl100k(cp, m, page_ids, pages)
    if profile == "gpt2":
        return _match_lengths_gpt2(cp, m, page_ids, pages)
    contractions = profile != "nocontract"
    c, mI, one = _batched(cp, m, column=True)
    N = c.shape[-1]
    idx = torch.arange(N, device=c.device)
    valid = idx < mI

    cls = _cls_lookup(c, page_ids, pages)
    ws = ((cls & WS) != 0) & valid
    rn = ((cls & RN) != 0) & valid
    let = (cls & LETTER) != 0
    num = ((cls & NUM) != 0) & valid
    uc = ((cls & UC) != 0) & valid
    lc = ((cls & LC) != 0) & valid
    wd = uc | lc
    p1 = ~(rn | let | num) & valid
    pu = ~((cls & WS) != 0) & ~let & ~((cls & NUM) != 0) & valid
    rns = (rn | (c == ord("/"))) & valid
    sp = (c == ord(" ")) & valid

    ws_run = _runlen(ws, idx, N)
    wd_run = _runlen(wd, idx, N)
    uc_run = _runlen(uc, idx, N)
    lc_run = _runlen(lc, idx, N)
    num_run = _runlen(num, idx, N)
    pu_run = _runlen(pu, idx, N)
    rns_run = _runlen(rns, idx, N)
    prevrn = _prevpos(rn, idx)
    prevlc = _prevpos(lc, idx)
    g = _take

    def wm1(j):
        R = g(wd_run, j)
        p = g(uc_run, j)
        lt = p + g(lc_run, j + p)
        s = g(prevlc, j + R - 1)
        eq = torch.where((s >= j) & (R > 0), s - j + 1, 0)
        return torch.where(R == 0, 0, torch.where(p < R, lt, eq))

    def wm2(j):
        p = g(uc_run, j)
        return torch.where(p > 0, p + g(lc_run, j + p), 0)

    if contractions:
        apo = (c == ord("'")) & valid
        one_, two = _fold_one_two(*_next_cps(c, idx, mI))
        ct_full = torch.where(apo & one_, 2, torch.where(apo & two, 3, 0))

        def ct(e):
            return g(ct_full, e)
    else:
        def ct(e):
            return torch.zeros_like(e)

    j1 = (idx + 1).expand(c.shape)
    idx2 = idx.expand(c.shape)

    w_pre = wm1(j1)
    w_nop = wm1(idx2)
    a1 = torch.where(p1 & (w_pre > 0), 1 + w_pre + ct(idx + 1 + w_pre),
                     torch.where(w_nop > 0, w_nop + ct(idx + w_nop), 0))
    w2_pre = wm2(j1)
    w2_nop = wm2(idx2)
    a2 = torch.where(p1 & (w2_pre > 0), 1 + w2_pre + ct(idx + 1 + w2_pre),
                     torch.where(w2_nop > 0, w2_nop + ct(idx + w2_nop), 0))
    a3 = torch.clamp(num_run, max=3)
    pu_pre = g(pu_run, j1)
    a4 = torch.where(
        sp & (pu_pre > 0), 1 + pu_pre + g(rns_run, idx + 1 + pu_pre),
        torch.where(pu_run > 0, pu_run + g(rns_run, idx + pu_run), 0))
    e_ws = idx + ws_run
    m_rn = g(prevrn, e_ws - 1)
    a5 = torch.where(ws & (m_rn >= idx), m_rn + 1 - idx, 0)
    a6 = _ws_tail(ws_run, e_ws == mI)
    a7 = ws_run
    lens = _first_positive(a1, a2, a3, a4, a5, a6, a7)
    return lens[0] if one else lens


def _ws_tail(ws_run, at_eos):
    """\\s+$ at the end, else \\s+(?!\\S) (one short of the run)."""
    return torch.where((ws_run > 0) & at_eos, ws_run,
                       torch.where(ws_run >= 2, ws_run - 1, 0))


def _first_positive(*alts) -> torch.Tensor:
    """The first alternative's length that is > 0, at least 1; int32."""
    lens = alts[-1]
    for a in reversed(alts[:-1]):
        lens = torch.where(a > 0, a, lens)
    return torch.clamp(lens, min=1).to(torch.int32)


def _match_lengths_cl100k(cp, m, page_ids, pages) -> torch.Tensor:
    """cl100k profile (scanner_ref._match_lengths_cl100k)."""
    c, mI, one = _batched(cp, m, column=True)
    N = c.shape[-1]
    idx = torch.arange(N, device=c.device)
    valid = idx < mI

    cls = _cls_lookup(c, page_ids, pages)
    ws = ((cls & WS) != 0) & valid
    rn = ((cls & RN) != 0) & valid
    let = ((cls & LETTER) != 0) & valid
    num = ((cls & NUM) != 0) & valid
    p1 = ~((cls & (RN | LETTER | NUM)) != 0) & valid
    pu = ~((cls & (WS | LETTER | NUM)) != 0) & valid
    sp = (c == ord(" ")) & valid

    ws_run = _runlen(ws, idx, N)
    let_run = _runlen(let, idx, N)
    num_run = _runlen(num, idx, N)
    pu_run = _runlen(pu, idx, N)
    rn_run = _runlen(rn, idx, N)
    prevrn = _prevpos(rn, idx)
    g = _take

    apo = (c == ord("'")) & valid
    one_, two = _fold_one_two(*_next_cps(c, idx, mI))
    c1 = torch.where(apo & one_, 2, torch.where(apo & two, 3, 0))

    j1 = (idx + 1).expand(c.shape)
    let_pre = g(let_run, j1)
    c2 = torch.where(p1, torch.where(let_pre > 0, 1 + let_pre, 0),
                     torch.where(let, let_run, 0))
    c3 = torch.clamp(num_run, max=3)
    pu_pre = g(pu_run, j1)
    c4 = torch.where(
        sp & (pu_pre > 0), 1 + pu_pre + g(rn_run, idx + 1 + pu_pre),
        torch.where(pu_run > 0, pu_run + g(rn_run, idx + pu_run), 0))
    e_ws = idx + ws_run
    m_rn = g(prevrn, e_ws - 1)
    c5 = torch.where(ws & (m_rn >= idx), m_rn + 1 - idx, 0)
    c6 = _ws_tail(ws_run, e_ws == mI)
    lens = _first_positive(c1, c2, c3, c4, c5, c6, ws_run)
    return lens[0] if one else lens


def _match_lengths_gpt2(cp, m, page_ids, pages) -> torch.Tensor:
    """gpt2/r50k/p50k profile (scanner_ref._match_lengths_gpt2):
    case-sensitive contractions, optional-space class runs."""
    c, mI, one = _batched(cp, m, column=True)
    N = c.shape[-1]
    idx = torch.arange(N, device=c.device)
    valid = idx < mI

    cls = _cls_lookup(c, page_ids, pages)
    ws = ((cls & WS) != 0) & valid
    let = ((cls & LETTER) != 0) & valid
    num = ((cls & NUM) != 0) & valid
    pu = ~((cls & (WS | LETTER | NUM)) != 0) & valid
    sp = (c == ord(" ")) & valid

    ws_run = _runlen(ws, idx, N)
    let_run = _runlen(let, idx, N)
    num_run = _runlen(num, idx, N)
    pu_run = _runlen(pu, idx, N)

    cp1, cp2 = _next_cps(c, idx, mI)
    apo = (c == ord("'")) & valid
    one_, two = _gpt2_one_two(cp1, cp2)
    g1 = torch.where(apo & one_, 2, torch.where(apo & two, 3, 0))

    j1 = (idx + 1).expand(c.shape)

    def sp_run(run):
        pre = _take(run, j1)
        return torch.where(sp & (pre > 0), 1 + pre,
                           torch.where(run > 0, run, 0))

    g5 = _ws_tail(ws_run, (idx + ws_run) == mI)
    lens = _first_positive(g1, sp_run(let_run), sp_run(num_run),
                           sp_run(pu_run), g5, ws_run)
    return lens[0] if one else lens


def _gpt2_one_two(cp1, cp2):
    """'s 'd 'm 't and 'll 've 're, case-sensitive."""
    one = ((cp1 == ord("s")) | (cp1 == ord("d")) | (cp1 == ord("m"))
           | (cp1 == ord("t")))
    two = (((cp1 == ord("l")) & (cp2 == ord("l")))
           | ((cp1 == ord("v")) & (cp2 == ord("e")))
           | ((cp1 == ord("r")) & (cp2 == ord("e"))))
    return one, two


def chain_starts(lens: torch.Tensor, m) -> torch.Tensor:
    """starts[i] = True iff a match begins at char i, by pointer doubling
    over the jump i -> i + lens[i] in ceil(log2 N) rounds (the JAX
    function's ``.at[jump].max`` is an int32 ``scatter_reduce_`` amax).
    ``lens`` (N,) or (B, N) int32 >= 1, ``m`` the valid char counts."""
    l2, mI, one = _batched(lens, m, column=True)
    B, N = l2.shape
    dev = l2.device
    idx = torch.arange(N, device=dev)
    jump = torch.clamp(idx + torch.clamp(l2.to(torch.int64), min=1), max=N)
    jump = torch.cat([jump, torch.full((B, 1), N, dtype=torch.int64,
                                       device=dev)], dim=1)
    mask = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
    mask[:, 0] = 1
    for _ in range(max(1, int(np.ceil(np.log2(max(2, N)))))):
        hit = torch.zeros_like(mask).scatter_reduce_(1, jump, mask,
                                                     reduce="amax")
        mask = mask | hit
        jump = torch.gather(jump, 1, jump)
    out = (mask[:, :N] != 0) & (idx < mI)
    return out[0] if one else out


# ===========================================================================
# Boundary-local piece starts, the char-per-element form
# ===========================================================================


def piece_starts(cp: torch.Tensor, m, page_ids, pages, *,
                 contractions: bool = True,
                 profile: str | None = None) -> torch.Tensor:
    """Piece-start flags, bool of ``cp``'s shape: scanner_ref.piece_starts
    as plain torch scans and shifts (the JAX ``piece_starts_jax``,
    statement for statement). Raises NotImplementedError for a profile
    outside the four (kimi's starts are ``bitplane.piece_starts_chars``)."""
    if profile is None:
        profile = "llama4" if contractions else "nocontract"
    if profile == "cl100k":
        return _piece_starts_cl100k(cp, m, page_ids, pages)
    if profile == "gpt2":
        return _piece_starts_gpt2(cp, m, page_ids, pages)
    if profile not in ("llama4", "nocontract"):
        raise NotImplementedError(
            f"no boundary-local derivation for: {profile}")
    contractions = profile == "llama4"
    c, mI, one = _batched(cp, m, column=True)
    N = c.shape[-1]
    dev = c.device
    idx = torch.arange(N, device=dev)
    valid = idx < mI

    cls = _cls_lookup(c, page_ids, pages)
    ws = ((cls & WS) != 0) & valid
    rn = ((cls & RN) != 0) & valid
    let = ((cls & LETTER) != 0) & valid
    num = ((cls & NUM) != 0) & valid
    uc = ((cls & UC) != 0) & valid
    lc = ((cls & LC) != 0) & valid
    wd = uc | lc
    pu_re = ~(ws | let | num) & valid
    mark = pu_re & wd
    sp = (c == ord(" ")) & valid
    apo = (c == ord("'")) & valid
    rnsl = (rn | (c == ord("/"))) & valid

    U = uc & ~lc
    L = lc & ~uc
    O = uc & lc
    false = torch.zeros(c.shape, dtype=torch.bool, device=dev)

    def prev(mk, k=1):
        return _shr(mk, k, False)

    def nxt(mk, k=1):
        return _shl(mk, k, False)

    rnsl_start = _prevpos(~rnsl, idx) + 1

    if contractions:
        fold_one, fold_two = _fold_one_two(*_next_cps(c, idx, mI))
    else:
        fold_one = fold_two = false

    # region partition (classes are static across fixpoint rounds)
    K = torch.where(ws, 0, torch.where(num, 1, torch.where(wd, 2, 3)))
    K = torch.where(valid, K, 4)
    newreg = _newreg(K)
    reg_start = _prevpos(newreg, idx)
    nxtreg = _nextpos_m(nxt(newreg), idx, mI)
    rend = torch.where(nxtreg < mI, nxtreg + 1, mI)

    # ================= mutually-recursive core ============================
    ct2 = false
    ct3 = false
    for _round in range(2 if contractions else 1):
        PUx = pu_re & ~wd & ~(ct2 | ct3)
        purc = PUx | mark
        pur_start = _prevpos(~purc, idx) + 1
        bad = PUx & ~nxt(mark)
        nbad = _nextpos_m(bad, idx, mI)

        def a4_cover(bound_into, absorbed, *, PUx=PUx, purc=purc,
                     pur_start=pur_start, nbad=nbad):
            entry = purc & ((idx == pur_start) | (~absorbed & prev(absorbed)))
            start_cover = PUx & bound_into & (idx == pur_start)
            seedval = torch.where(start_cover, idx, nbad)
            cover_from = _ffill_at_j(entry, seedval)
            covered = purc & (cover_from >= 0) & (idx >= cover_from)
            return covered, cover_from

        def absorption(a4_valid, *, purc=purc):
            t0 = rn & prev(a4_valid & purc)
            pt0 = _prevpos(t0, idx)
            return rnsl & (pt0 >= rnsl_start)

        def ws_rules(absorbed):
            ws_entry = ws & ~absorbed & (prev(~ws) | prev(absorbed)
                                         | (idx == 0))
            nextrn_l = _nextpos_m(rn & ~absorbed, idx, mI)
            is_last_rn = rn & ~absorbed & (_shl(nextrn_l, 1, mI) >= rend)
            b_after_rn = ws & prev(is_last_rn)
            in_tail = ws & ~rn & ~absorbed & (nextrn_l >= rend)
            tail_start = in_tail & ~prev(in_tail)
            tail_start_pos = torch.where(in_tail, _prevpos(tail_start, idx),
                                         -1)
            at_last = in_tail & (idx == rend - 1) & (rend < mI)
            eligible = at_last & ((nxt(wd) & ~rn) | (sp & nxt(pu_re)))
            b_ws_split = at_last & (tail_start_pos >= 0) & (
                idx > tail_start_pos)
            bound_into = prev(eligible)
            b_ws = (ws_entry | b_after_rn | b_ws_split) & ws
            return b_ws, bound_into

        absorbed = false
        for _ in range(4):
            a4_covered, cover_from = a4_cover(false, absorbed)
            absorbed = absorption(a4_covered)
        _, bound_into0 = ws_rules(absorbed)
        for _ in range(4):
            a4_covered, cover_from = a4_cover(bound_into0, absorbed)
            absorbed = absorption(a4_covered)
        flow_marks = mark & _ffill_bool_at_j(~mark,
                                             a4_covered & PUx & ~absorbed)
        b_ws, bound_into = ws_rules(absorbed)

        if not contractions:
            break
        # ---- contraction absorption ------------------------------------
        word_end_char = (wd & ~mark) | (
            mark & ~(flow_marks | (a4_covered & mark)))
        ct2 = apo & prev(word_end_char) & fold_one
        ct3 = apo & prev(word_end_char) & fold_two & ~fold_one
        accept = _ct_chain_accept(ct2, ct3, ~nxt(wd, 2), ~nxt(wd, 3))
        ct2 = ct2 & accept
        ct3 = ct3 & accept

    ct_any = ct2 | ct3
    absorbed_letters = prev(ct2) | prev(ct3) | prev(ct3, 2)
    forced_entry = wd & (prev(ct2, 2) | prev(ct3, 3)) & ~absorbed_letters

    # ================= boundary rules =====================================
    b_num = num & (((idx - reg_start) % 3) == 0)

    # absorbed letters end the preceding piece: the word rules' run
    # restarts after them (lockstep with scanner_ref)
    wd_start = _prevpos(~wd | absorbed_letters, idx) + 1
    pL = _prevpos(L, idx)
    pU = _prevpos(U, idx)
    nL = _nextpos_m(L, idx, mI)
    nO = _nextpos_m(O, idx, mI)
    wd_end = _nextpos_m(~wd, idx, mI)
    p_prev_L = _shr(pL, 1, -1)
    p_prev_U = _shr(pU, 1, -1)
    r1 = U & (p_prev_L > p_prev_U) & (p_prev_L >= wd_start)
    r2 = U & prev(O) & (nO >= wd_end) & (nL >= wd_end) & ~r1

    b_wd = (r1 | r2 | forced_entry) & ~absorbed_letters & ~flow_marks
    b_wd = b_wd | (wd & ~mark & prev(flow_marks))

    # ---- PU interior: alternation entries ----------------------------------
    PUx = pu_re & ~wd & ~ct_any
    purc = PUx | mark
    pur_alt = PUx & prev(mark) & (idx > pur_start) & (
        ~a4_covered | (idx == cover_from))
    b_pu = pur_alt & ~absorbed

    # ---- assemble -----------------------------------------------------------
    base = b_ws | b_num | b_wd | b_pu
    base = base | (newreg & ~ws & ~purc & valid)
    base = base | (purc & (idx == pur_start))
    base = base | (purc & ~absorbed & prev(absorbed))

    sup = absorbed | flow_marks | absorbed_letters | bound_into | ct_any
    word_attached_mark = mark & _ffill_bool_at_j(~mark, wd & ~mark)
    sup = sup | (word_attached_mark & ~forced_entry)

    p1 = ~(rn | let | num) & valid
    base_start = torch.where(
        ws, base & ~sup,
        torch.where(num, base, (purc & ~wd) & base & ~sup))
    prefix_bind = wd & prev(base_start & p1 & ~wd & ~absorbed_letters)
    sup = sup | prefix_bind
    return _first_flag(base & ~sup & valid, mI, one)


def _piece_starts_gpt2(cp, m, page_ids, pages) -> torch.Tensor:
    """scanner_ref._piece_starts_gpt2 (the JAX ``_piece_starts_gpt2_jax``):
    scans and static shifts only."""
    c, mI, one = _batched(cp, m, column=True)
    idx = torch.arange(c.shape[-1], device=c.device)
    valid = idx < mI

    cls = _cls_lookup(c, page_ids, pages)
    ws = ((cls & WS) != 0) & valid
    let = ((cls & LETTER) != 0) & valid
    num = ((cls & NUM) != 0) & valid
    pu = ~(ws | let | num) & valid
    sp = (c == ord(" ")) & valid
    apo = (c == ord("'")) & valid

    def prev(mk, k=1):
        return _shr(mk, k, False)

    K = torch.where(ws, 0, torch.where(let, 1, torch.where(num, 2, 3)))
    newreg = _newreg(torch.where(valid, K, 4))

    last_ws_mid = ws & _shl(valid & ~ws, 1, False)
    b_ws = (ws & newreg) | (last_ws_mid & prev(ws))
    bind_ws = last_ws_mid & sp

    one_, two = _gpt2_one_two(*_next_cps(c, idx, mI))
    ct_ok = apo & pu & newreg & ~prev(bind_ws)
    ct2 = ct_ok & one_
    ct3 = ct_ok & two & ~one_
    absorbed_letters = prev(ct2) | prev(ct3) | prev(ct3, 2)
    forced_entry = let & (prev(ct2, 2) | prev(ct3, 3))

    base = b_ws | (newreg & ~ws & valid) | forced_entry
    sup = (prev(bind_ws) & ~ws) | absorbed_letters
    return _first_flag(base & ~sup & valid, mI, one)


def _piece_starts_cl100k(cp, m, page_ids, pages) -> torch.Tensor:
    """scanner_ref._piece_starts_cl100k (the JAX
    ``_piece_starts_cl100k_jax``): scans and static shifts only."""
    c, mI, one = _batched(cp, m, column=True)
    idx = torch.arange(c.shape[-1], device=c.device)
    valid = idx < mI

    cls = _cls_lookup(c, page_ids, pages)
    ws = ((cls & WS) != 0) & valid
    rn = ((cls & RN) != 0) & valid
    let = ((cls & LETTER) != 0) & valid
    num = ((cls & NUM) != 0) & valid
    pu = ~(ws | let | num) & valid
    sp = (c == ord(" ")) & valid
    apo = (c == ord("'")) & valid

    def prev(mk, k=1):
        return _shr(mk, k, False)

    def nxt(mk, k=1):
        return _shl(mk, k, False)

    K = torch.where(ws, 0, torch.where(let, 1, torch.where(num, 2, 3)))
    newreg = _newreg(torch.where(valid, K, 4))
    reg_start = _prevpos(newreg, idx)
    nxtreg = _nextpos_m(nxt(newreg), idx, mI)
    rend = torch.where(nxtreg < mI, nxtreg + 1, mI)

    # C4 [\r\n]* tail absorption
    rn_seed = rn & ~prev(rn) & prev(pu)
    rn_start = _prevpos(~rn, idx) + 1
    absorbed = rn & (_prevpos(rn_seed, idx) >= rn_start)

    # ws rules
    ws_entry = ws & ~absorbed & (prev(~ws) | prev(absorbed) | (idx == 0))
    nextrn_l = _nextpos_m(rn & ~absorbed, idx, mI)
    is_last_rn = rn & ~absorbed & (_shl(nextrn_l, 1, mI) >= rend)
    b_after_rn = ws & prev(is_last_rn)
    in_tail = ws & ~rn & ~absorbed & (nextrn_l >= rend)
    at_last = in_tail & (idx == rend - 1) & (rend < mI)
    eligible = at_last & (nxt(let) | (sp & nxt(pu)))
    b_ws_split = at_last & prev(in_tail)
    bound_into = prev(eligible)
    b_ws = ws_entry | b_after_rn | b_ws_split

    # contractions (case-insensitive fold)
    fold_one, fold_two = _fold_one_two(*_next_cps(c, idx, mI))
    pu_start = pu & newreg
    ct_ok = apo & pu_start & ~bound_into
    ct2 = ct_ok & fold_one
    ct3 = ct_ok & fold_two & ~fold_one
    ct_any = ct2 | ct3
    absorbed_letters = prev(ct2) | prev(ct3) | prev(ct3, 2)
    forced_entry = let & (prev(ct2, 2) | prev(ct3, 3)) & ~absorbed_letters
    bind_pu = pu_start & ~bound_into & ~ct_any & nxt(let)

    b_num = num & (((idx - reg_start) % 3) == 0)
    base = b_ws | b_num | (newreg & (let | pu)) | forced_entry
    sup = absorbed | absorbed_letters | bound_into | prev(bind_pu)
    return _first_flag(base & ~sup & valid, mI, one)


# ===========================================================================
# Piece arrays, the whole scan, and the starts of any profile
# ===========================================================================


def compact_pieces(starts: torch.Tensor, byte_of_char: torch.Tensor,
                   nbytes):
    """Char-level start flags to piece (start, len) byte arrays: (start_b
    int32 padded with nbytes, piece_len int32 0-padded, n_pieces int32),
    shapes as ``starts``' (the JAX ``compact_pieces``)."""
    s, nb, one = _batched(starts, nbytes, column=True)
    boc = byte_of_char[None] if one else byte_of_char
    B, N = s.shape
    idx = torch.arange(N, device=s.device)
    pid = torch.cumsum(s, dim=1) - 1
    n_pieces = torch.clamp(pid[:, -1:] + 1, min=0)
    start_b = torch.empty((B, N + 1), dtype=torch.int64, device=s.device)
    start_b.copy_(nb.expand(B, N + 1))
    start_b.scatter_(1, torch.where(s, pid, N),
                     torch.where(s, boc.to(torch.int64), 0))
    start_b = start_b[:, :N]
    end_b = torch.where(idx == n_pieces - 1, nb, _shl(start_b, 1, 0))
    piece_len = torch.where(idx < n_pieces, end_b - start_b, 0)
    out = (start_b.to(torch.int32), piece_len.to(torch.int32),
           n_pieces[:, 0].to(torch.int32))
    return tuple(o[0] for o in out) if one else out


def compute_starts(cp: torch.Tensor, m, page_ids, pages, *,
                   contractions: bool = True,
                   profile: str | None = None) -> torch.Tensor:
    """Char-level piece-start flags for any profile, bool of ``cp``'s
    shape. The four profiles: a CUDA tensor launches kernel K1
    (``bitplane.piece_starts_chars``: its codepoint entry, or its row
    entry for N <= 4,096), a CPU tensor runs the char form
    (``piece_starts``), as the JAX package takes its bit-plane form off
    the CPU backend only. kimi (no char form): ``piece_starts_chars`` on
    either device. Any other profile: ``match_lengths`` and
    ``chain_starts`` on either device."""
    eff = profile or ("llama4" if contractions else "nocontract")
    if eff == "kimi":
        return piece_starts_chars(cp, m, profile=eff)
    if eff in ("llama4", "nocontract", "cl100k", "gpt2"):
        if cp.is_cuda:
            return piece_starts_chars(cp, m, profile=eff)
        return piece_starts(cp, m, page_ids, pages,
                            contractions=contractions, profile=profile)
    lens = match_lengths(cp, m, page_ids, pages, contractions=contractions,
                         profile=profile)
    return chain_starts(lens, m)


def scan_bytes(data: torch.Tensor, nbytes, page_ids, pages, *,
               contractions: bool = True, profile: str | None = None,
               use_pallas: bool = False):
    """The whole pretokenizer scan: (piece_start int32 byte offsets padded
    with nbytes, piece_len int32 0-padded, n_pieces int32). The decode is
    ``utf8_decode`` (K9 and K4 on a card) whatever ``use_pallas`` says:
    the JAX package's Pallas/XLA choice has no counterpart here."""
    del use_pallas
    cp, _, byte_of_char, m = utf8_decode(data, nbytes)
    starts = compute_starts(cp, m, page_ids, pages,
                            contractions=contractions, profile=profile)
    return compact_pieces(starts, byte_of_char, nbytes)
