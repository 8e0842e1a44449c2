"""Whole-piece vocab hash table (``vhash8``) and the decode tables.

One bucket row per hash value holds 8 slots of [k0, k1, k2, k3, len,
rank] (48 int32 = 192 B), slot-major: [k0 x8][k1 x8]...[rank x8]. The
keys are a token's first 16 bytes as four little-endian words, zero
padded; only tokens of at most 16 bytes enter. Entries that do not fit
their bucket are dropped: a lookup of such a token is a deliberate miss,
which the host splice resolves exactly with its whole-piece dict lookup
first. Bit-identical to the JAX package's ``tables._build_vocab_hash8``.
"""

from __future__ import annotations

import numpy as np

# multiplicative mixing constants of the hash (choice 0 is the one used)
_MIX = (
    (0x9E3779B1, 0x85EBCA77, 0x7FEB352D),
    (0xC2B2AE3D, 0x27D4EB2F, 0x165667B1),
)


def _mix_hash(a: np.ndarray, b: np.ndarray, which: int, mask: int) -> np.ndarray:
    """32-bit multiply-xor mix of a word pair, uint32 wraparound."""
    c1, c2, c3 = _MIX[which]
    h = a.astype(np.uint32) * np.uint32(c1) + b.astype(np.uint32) * np.uint32(c2)
    h ^= h >> np.uint32(16)
    h *= np.uint32(c3)
    h ^= h >> np.uint32(15)
    return (h & np.uint32(mask)).astype(np.int64)


def _vhash_ab(k0: np.ndarray, k1: np.ndarray, k2: np.ndarray,
              k3: np.ndarray, length: np.ndarray):
    """Fold the 4 key words + length into the (a, b) pair fed to
    _mix_hash. uint32 wraparound; ops/join.vhash_ab is its torch twin."""
    a = (k0.astype(np.uint32) * np.uint32(0x85EBCA77)
         + k2.astype(np.uint32) * np.uint32(31)
         + length.astype(np.uint32) * np.uint32(131))
    b = (k1.astype(np.uint32) * np.uint32(0xC2B2AE3D)
         + k3.astype(np.uint32) * np.uint32(31))
    return a.astype(np.int32), b.astype(np.int32)


def _build_vocab_hash8(vocab_keys: np.ndarray, vocab_lens: np.ndarray,
                       vocab_ranks: np.ndarray):
    """Single-hash bucketed table; returns (rows (nb, 48) int32, mask,
    dropped entry count)."""
    n = len(vocab_lens)
    a_all, b_all = _vhash_ab(
        vocab_keys[:, 0], vocab_keys[:, 1], vocab_keys[:, 2],
        vocab_keys[:, 3], vocab_lens,
    )
    nbuckets = 1 << max(10, int(np.ceil(np.log2(max(1, n) / 1.5))))
    mask = nbuckets - 1
    slots = np.zeros((nbuckets, 8, 6), dtype=np.int32)
    slots[:, :, 4] = -1  # len == -1 marks empty
    h = _mix_hash(a_all, b_all, 0, mask)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    group_start = np.r_[0, np.flatnonzero(np.diff(hs)) + 1]
    rank_in_group = np.arange(len(hs)) - np.repeat(
        group_start, np.diff(np.r_[group_start, len(hs)])
    )
    accept = rank_in_group < 8
    idx = order[accept]
    bkt = hs[accept]
    sl = rank_in_group[accept]
    slots[bkt, sl, 0:4] = vocab_keys[idx].view(np.int32)
    slots[bkt, sl, 4] = vocab_lens[idx]
    slots[bkt, sl, 5] = vocab_ranks[idx]
    rows = slots.transpose(0, 2, 1).reshape(nbuckets, 48).copy()
    return rows, mask, int(n - accept.sum())


def vocab_keys(ranks: dict[bytes, int]):
    """Whole-piece join keys of every token of at most 16 bytes:
    (keys (V, 4) uint32 little-endian zero-padded, lens (V,), ranks (V,))."""
    short = [(tb, rank) for tb, rank in ranks.items() if len(tb) <= 16]
    V = len(short)
    kbuf = np.zeros((V, 16), dtype=np.uint8)
    lens = np.zeros(V, dtype=np.int32)
    rks = np.zeros(V, dtype=np.int32)
    for i, (tb, rank) in enumerate(short):
        kbuf[i, : len(tb)] = np.frombuffer(tb, dtype=np.uint8)
        lens[i] = len(tb)
        rks[i] = rank
    return kbuf.view("<u4").reshape(V, 4), lens, rks


def build_vhash8(ranks: dict[bytes, int]):
    """(rows (nb, 48) int32, mask, dropped) for a mergeable-ranks dict."""
    return _build_vocab_hash8(*vocab_keys(ranks))


def build_decode_tables(ranks: dict[bytes, int], specials: dict[str, int]):
    """rank -> bytes tables for decode, ordinary and special ids in one
    address space: (offsets (V,) int64, lengths (V,) int32 with -1 for an
    unknown id, blob uint8, n_vocab = V), V = the largest id + 1.
    Identical to the decode fields of the JAX package's ``build_tables``."""
    max_id = max(max(ranks.values()), max(specials.values(), default=0))
    n_ids = max_id + 1
    lengths = np.full(n_ids, -1, dtype=np.int32)
    offsets = np.zeros(n_ids, dtype=np.int64)
    parts: list[bytes] = []
    off = 0
    items = list(ranks.items()) + [(s.encode("utf-8"), r)
                                   for s, r in specials.items()]
    for tb, rank in items:
        offsets[rank] = off
        lengths[rank] = len(tb)
        parts.append(tb)
        off += len(tb)
    blob = np.frombuffer(b"".join(parts), dtype=np.uint8).copy()
    return offsets, lengths, blob, n_ids
