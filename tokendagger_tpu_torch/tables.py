"""Whole-piece vocab hash table (``vhash8``), the pair-merge tables and
the decode tables.

One bucket row per hash value holds 8 slots of [k0, k1, k2, k3, len,
rank] (48 int32 = 192 B), slot-major: [k0 x8][k1 x8]...[rank x8]. The
keys are a token's first 16 bytes as four little-endian words, zero
padded; only tokens of at most 16 bytes enter. Entries that do not fit
their bucket are dropped: a lookup of such a token is a deliberate miss,
which the host splice resolves exactly with its whole-piece dict lookup
first. Bit-identical to the JAX package's ``tables._build_vocab_hash8``.

The pair-merge tables serve the device BPE merge (``ops/merge.py``).
During a merge every part is a vocab token, so the rank of the bytes of
two adjacent parts is a function of their two ids: ``PairTable`` maps
``(a, b) -> rank(bytes(a) + bytes(b))`` over every 2-split of every
token, as a two-choice bucketed hash whose lookup reads at most two
48-byte rows. ``byte_rank`` gives the first ids and ``pair_lut`` the
first-round ranks of byte pairs. All are bit-identical to the JAX
package's ``tables.build_tables`` fields.

``build_vocab_hash`` is the JAX package's 4-slot, two-choice whole-piece
table (``tables._build_vocab_hash``), read by ``ops/join.vocab_probe``;
no path builds it. ``all_reachable`` is the merge-reachability audit
that ``parallel/sharded_text.ShardedTextEncoder`` requires.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .hostengine import byte_pair_encode

MAX_RANK = np.int32(0x7FFFFFFF)
BUCKET = 4  # slots per pair-table bucket

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
    order, rank_in_group = _bucket_slots(h, np.zeros(nbuckets, np.int64))
    hs = h[order]
    accept = rank_in_group < 8
    idx = order[accept]
    bkt = hs[accept]
    sl = rank_in_group[accept]
    slots[bkt, sl, 0:4] = vocab_keys[idx].view(np.int32)
    slots[bkt, sl, 4] = vocab_lens[idx]
    slots[bkt, sl, 5] = vocab_ranks[idx]
    rows = slots.transpose(0, 2, 1).reshape(nbuckets, 48).copy()
    return rows, mask, int(n - accept.sum())


def build_vocab_hash(vocab_keys: np.ndarray, vocab_lens: np.ndarray,
                     vocab_ranks: np.ndarray):
    """Two-choice bucketed hash over whole-piece keys, with the insertion
    strategy of ``PairTable.build``: (rows (nb, 24) int32, mask). Rows
    are slot-major, 4 slots x [k0, k1, k2, k3, len, rank]
    ([k0 x4][k1 x4]...[rank x4]); empty slots have len == -1.
    Bit-identical to the JAX package's ``tables._build_vocab_hash``."""
    n = len(vocab_lens)
    a_all, b_all = _vhash_ab(
        vocab_keys[:, 0], vocab_keys[:, 1], vocab_keys[:, 2],
        vocab_keys[:, 3], vocab_lens,
    )
    nbuckets = 1 << max(10, int(np.ceil(np.log2(max(1, n) / 1.5))))
    for _attempt in range(3):
        mask = nbuckets - 1
        slots = np.zeros((nbuckets, 4, 6), dtype=np.int32)
        slots[:, :, 4] = -1  # len == -1 marks empty
        fill = np.zeros(nbuckets, dtype=np.int64)
        remaining = np.arange(n)
        for which in (0, 1):
            if len(remaining) == 0:
                break
            h = _mix_hash(a_all[remaining], b_all[remaining], which, mask)
            order, slot = _bucket_slots(h, fill)
            hs = h[order]
            accept = slot < 4
            idx = remaining[order][accept]
            bkt, sl = hs[accept], slot[accept]
            slots[bkt, sl, 0:4] = vocab_keys[idx].view(np.int32)
            slots[bkt, sl, 4] = vocab_lens[idx]
            slots[bkt, sl, 5] = vocab_ranks[idx]
            np.add.at(fill, bkt, 1)
            remaining = remaining[order][~accept]
        if len(remaining) == 0:
            return slots.transpose(0, 2, 1).reshape(nbuckets, 24).copy(), mask
        nbuckets <<= 1  # a bucket overflowed: grow, retry
    raise RuntimeError("vocab hash table build failed after growth retries")


def unreachable(ranks: dict[bytes, int]) -> Iterator[bytes]:
    """Each multi-byte token that the BPE merge of its own bytes does not
    produce (or that holds a byte without a rank), in ``ranks``' order:
    one Python merge per token, seconds for a 200,000-token vocabulary."""
    for tb, rank in ranks.items():
        if len(tb) < 2:
            continue
        if (any(bytes([b]) not in ranks for b in tb)
                or byte_pair_encode(tb, ranks) != [rank]):
            yield tb


def all_reachable(ranks: dict[bytes, int]) -> bool:
    """The merge-reachability audit of the JAX package's ``build_tables``
    (``DeviceTables.all_reachable``): every multi-byte token is the merge
    of its bytes, so a merge-only encoder equals tiktoken's
    lookup-then-merge."""
    return next(unreachable(ranks), None) is None


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


def _bucket_slots(h: np.ndarray, fill: np.ndarray) -> np.ndarray:
    """Slot of each key in its bucket ``h`` when keys are placed in order
    (stable by bucket) after the ``fill`` already there; returns (order,
    slot in that order)."""
    order = np.argsort(h, kind="stable")
    hs = h[order]
    group_start = np.r_[0, np.flatnonzero(np.diff(hs)) + 1]
    rank_in_group = np.arange(len(hs)) - np.repeat(
        group_start, np.diff(np.r_[group_start, len(hs)]))
    return order, fill[hs] + rank_in_group


@dataclass
class PairTable:
    """Two-choice bucketed hash table for (a, b) -> merged rank.

    ``rows`` (nbuckets, 12) int32: per bucket 4 slots laid out as
    [ka0..ka3, kb0..kb3, val0..val3]; empty slots have ka == -1. A lookup
    reads the row of the first hash, then the second's, and compares 4
    slots in each."""

    rows: np.ndarray
    mask: int  # nbuckets - 1
    n_keys: int

    @staticmethod
    def build(pairs_a: np.ndarray, pairs_b: np.ndarray,
              vals: np.ndarray) -> "PairTable":
        n = len(pairs_a)
        nbuckets = 1 << max(10, int(np.ceil(np.log2(max(1, n) / 1.5))))
        for _attempt in range(3):
            mask = nbuckets - 1
            ka = np.full((nbuckets, BUCKET), -1, dtype=np.int32)
            kb = np.zeros((nbuckets, BUCKET), dtype=np.int32)
            va = np.zeros((nbuckets, BUCKET), dtype=np.int32)
            fill = np.zeros(nbuckets, dtype=np.int64)
            remaining = np.arange(n)
            for which in (0, 1):
                if len(remaining) == 0:
                    break
                h = _mix_hash(pairs_a[remaining], pairs_b[remaining], which,
                              mask)
                order, slot = _bucket_slots(h, fill)
                hs = h[order]
                accept = slot < BUCKET
                idx = remaining[order][accept]
                bkt, sl = hs[accept], slot[accept]
                ka[bkt, sl] = pairs_a[idx]
                kb[bkt, sl] = pairs_b[idx]
                va[bkt, sl] = vals[idx]
                np.add.at(fill, bkt, 1)
                remaining = remaining[order][~accept]
            if len(remaining) == 0:
                return PairTable(rows=np.concatenate([ka, kb, va], axis=1),
                                 mask=mask, n_keys=n)
            nbuckets <<= 1  # a bucket overflowed (very rare): grow, retry
        raise RuntimeError("pair hash table build failed after growth "
                           "retries")

    def lookup_np(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """rank(bytes(a) + bytes(b)) per element, MAX_RANK on a miss."""
        out = np.full(a.shape, MAX_RANK, dtype=np.int32)
        for which in (0, 1):
            rows = self.rows[_mix_hash(a, b, which, self.mask)]
            hit = ((rows[..., 0:4] == a[..., None])
                   & (rows[..., 4:8] == b[..., None]))
            vals = np.where(hit, rows[..., 8:12], -1).max(-1)
            out = np.where(hit.any(-1) & (out == MAX_RANK), vals, out)
        return out


def pair_relation(ranks: dict[bytes, int]):
    """(a, b, rank) int32 arrays: for every token and every 2-split of its
    bytes into two tokens, their ranks and the token's."""
    pa: list[int] = []
    pb: list[int] = []
    pv: list[int] = []
    for tb, rank in ranks.items():
        for i in range(1, len(tb)):
            ra = ranks.get(tb[:i])
            if ra is None:
                continue
            rb = ranks.get(tb[i:])
            if rb is not None:
                pa.append(ra)
                pb.append(rb)
                pv.append(rank)
    return (np.asarray(pa, dtype=np.int32), np.asarray(pb, dtype=np.int32),
            np.asarray(pv, dtype=np.int32))


def byte_rank(ranks: dict[bytes, int]) -> np.ndarray:
    """(256,) int32 rank of each single byte, -1 where it has none."""
    out = np.full(256, -1, dtype=np.int32)
    for i in range(256):
        r = ranks.get(bytes([i]))
        if r is not None:
            out[i] = r
    return out


def pair_lut(ranks: dict[bytes, int]) -> np.ndarray:
    """(256, 256) int32 rank of each 2-byte token, MAX_RANK where none."""
    out = np.full((256, 256), MAX_RANK, dtype=np.int32)
    for tb, rank in ranks.items():
        if len(tb) == 2:
            out[tb[0], tb[1]] = rank
    return out


def build_pair_table(ranks: dict[bytes, int]) -> PairTable:
    """The pair-merge table of a mergeable-ranks dict."""
    return PairTable.build(*pair_relation(ranks))
