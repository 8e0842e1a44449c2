"""Piece key words and the whole-piece vocab probe.

Pieces are keyed by their first 16 bytes (4 little-endian words, zero
padded, masked to the piece length) plus the byte length. The probe
gathers ONE 8-slot bucket row of the ``vhash8`` table per piece and
compares all slots exactly: rank on a hit, -1 on a miss. A miss can be
deliberate (bucket overflow entries are dropped from the table); the host
splice does the oracle's whole-piece dict lookup first, so it is exact.

This stage is plain torch on every device: the JAX package runs it as
plain XLA too (``ops/join.vocab_probe8t_chunks``, whose 16/48/96-way
chunking only worked around the TPU's gather scheduling).

``vocab_probe_hot`` answers a host-chosen set of hot pieces by compare and
probes only the rest, compacted to a dense prefix by kernel K5+K6 and put
back by K7+K8 (``compact.compact_record`` / ``expand_route``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .merge import M32, _mix, mul32, u32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _zero_beyond(data: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """(..., N) bytes as int64, zero at or beyond ``nbytes`` (per row)."""
    N = data.shape[-1]
    idx = torch.arange(N, device=data.device)
    nb = torch.as_tensor(nbytes, device=data.device).to(torch.int64)
    return torch.where(idx < nb[..., None], data.to(torch.int64), 0)


def _shift_left_slots(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = x[i + k], zero past the end (last axis)."""
    if k == 0:
        return x
    pad = torch.zeros(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    return torch.cat([x[..., k:], pad], dim=-1)


def sliding_word0(data: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """w0[i] = bytes i..i+3 little-endian, zero beyond ``nbytes``; int64
    holding the uint32 value. ``data`` is (N,) or (B, N) with ``nbytes``
    a scalar or (B,)."""
    d = _zero_beyond(data, nbytes)
    return (d | (_shift_left_slots(d, 1) << 8)
            | (_shift_left_slots(d, 2) << 16)
            | (_shift_left_slots(d, 3) << 24))


def sliding_words(data: torch.Tensor, nbytes: torch.Tensor):
    """Four arrays: w[j][i] = bytes i+4j .. i+4j+3 (see sliding_word0)."""
    w0 = sliding_word0(data, nbytes)
    return tuple(_shift_left_slots(w0, 4 * j) for j in range(4))


def vhash_ab(k0, k1, k2, k3, length):
    """The (a, b) pair the bucket hash mixes (tables._vhash_ab), as int64
    holding uint32 values."""
    a = (mul32(u32(k0), 0x85EBCA77) + mul32(u32(k2), 31)
         + mul32(u32(length), 131)) & M32
    b = (mul32(u32(k1), 0xC2B2AE3D) + mul32(u32(k3), 31)) & M32
    return a, b


def vocab_probe8(qk0, qk1, qk2, qk3, qlen, rows: torch.Tensor,
                 mask: int) -> torch.Tensor:
    """Rank of each piece whose key words and length match a slot of its
    bucket row, else -1. Keys are int32 tensors (uint32 bits), ``qlen``
    int32, ``rows`` the (nb, 48) int32 vhash8 table on the same device;
    any leading shape."""
    a, b = vhash_ab(qk0, qk1, qk2, qk3, qlen)
    h = _mix(a, b, 0, mask)
    r = rows[h]                                          # (..., 48)
    keys = (qk0, qk1, qk2, qk3, qlen)
    hit = torch.ones(r.shape[:-1] + (8,), dtype=torch.bool, device=r.device)
    for j, q in enumerate(keys):
        hit &= r[..., 8 * j : 8 * j + 8] == q.to(torch.int32)[..., None]
    ranks = torch.where(hit, r[..., 40:48], -1)
    return ranks.amax(dim=-1).to(torch.int32)


def piece_key_words(piece: bytes) -> tuple[int, int, int, int, int]:
    """Host-side (k0, k1, k2, k3, len) of a piece, the key words as uint32
    values (Python ints): the first 16 bytes little-endian, zero padded,
    as ``compact.compact_piece_keys`` derives them on the device."""
    b = piece[:16] + b"\0" * max(0, 16 - len(piece))
    return (
        int.from_bytes(b[0:4], "little"),
        int.from_bytes(b[4:8], "little"),
        int.from_bytes(b[8:12], "little"),
        int.from_bytes(b[12:16], "little"),
        len(piece),
    )


def _key_hash(k0, k1, k2, k3, length) -> torch.Tensor:
    """int64 hash of a key, one-to-one on the bucket hash's (a, b) pair."""
    a, b = vhash_ab(k0, k1, k2, k3, length)
    return (b - 2**31) * 2**32 + a


@lru_cache(maxsize=8)
def _hot_table(hot_keys: tuple, hot_ranks: tuple, device: str):
    """The hot keys as device tensors: (hashes sorted, the (5, K) int32
    key words and lengths in that order, their ranks) for keys whose hash
    no other hot key shares, and the list of (key words, rank) of the
    rest, in their given order, for a plain compare."""
    if not hot_keys:
        return None, []
    k = torch.tensor(np.asarray(hot_keys, np.int64))            # (K, 5)
    words = [to_i32(k[:, j]) for j in range(4)] + [k[:, 4].to(torch.int32)]
    r = torch.tensor(np.asarray(hot_ranks, np.int64)).to(torch.int32)
    h = _key_hash(*words)
    _, inv, cnt = torch.unique(h, return_inverse=True, return_counts=True)
    alone = cnt[inv] == 1
    order = torch.argsort(torch.where(alone, h, h.max() + 1))[
        : int(alone.sum())]
    table = (h[order].to(device),
             torch.stack([w[order] for w in words]).to(device),
             r[order].to(device)) if len(order) else None
    rest = [(tuple(int(w[i]) for w in words), int(r[i]))
            for i in torch.nonzero(~alone).flatten().tolist()]
    return table, rest


def vocab_probe_hot(qk0, qk1, qk2, qk3, qlen, rows: torch.Tensor, mask: int,
                    *, hot_keys: tuple, hot_ranks: tuple, u_cap: int):
    """Whole-piece lookup with hot-piece pre-answering: the JAX
    ``join.vocab_probe_hot``. Returns (rank (B, P) int32, overflow (B,)
    bool).

    ``qk0..qk3`` (B, P) int32 key words (uint32 bits), ``qlen`` (B, P)
    int32 lengths (0 = dead slot); ``hot_keys`` are ``piece_key_words``
    tuples of pieces of at most 16 bytes (so equal words and length mean
    the same piece) with their ``hot_ranks`` (-1 for a piece outside the
    vocabulary). A live slot equal to a hot key takes its rank (the last
    such key's); the other live slots are compacted to a (B, u_cap) prefix
    (kernel K5+K6), probed with ``vocab_probe8`` there and put back
    (K7+K8); dead slots get -1. ``overflow`` is set where a window's
    non-hot pieces exceed ``u_cap``; its ranks are then wrong.

    Hot keys are matched by a sorted 64-bit hash of each slot's key,
    confirmed word by word, so the cost does not grow with their number;
    keys whose hashes collide are compared one by one."""
    from .compact import compact_record, expand_route

    keys = (qk0, qk1, qk2, qk3, qlen)
    table, rest = _hot_table(tuple(hot_keys), tuple(hot_ranks),
                             str(qk0.device))
    hot = torch.zeros(qk0.shape, dtype=torch.bool, device=qk0.device)
    rhot = torch.full(qk0.shape, -1, dtype=torch.int32, device=qk0.device)
    if table is not None:
        hh, hw, hr = table
        pos = torch.searchsorted(hh, _key_hash(*keys)).clamp(
            max=hh.shape[0] - 1)
        hot = torch.ones_like(hot)
        for j, q in enumerate(keys):
            hot &= hw[j][pos] == q
        rhot = torch.where(hot, hr[pos], rhot)
    for words, r in rest:
        m = torch.ones_like(hot)
        for w, q in zip(words, keys):
            m &= q == w
        hot |= m
        rhot = torch.where(m, r, rhot)
    live = qlen > 0
    unknown = live & ~hot
    dense, n_unknown, route = compact_record(list(keys), unknown, cap=u_cap)
    r_u = vocab_probe8(*dense, rows, mask)
    r_back = expand_route(r_u, route, unknown)
    rank = torch.where(hot, rhot, torch.where(unknown, r_back, -1))
    return torch.where(live, rank, -1).to(torch.int32), n_unknown > u_cap
