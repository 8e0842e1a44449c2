"""Piece key words and the whole-piece vocab probe.

Pieces are keyed by their first 16 bytes (4 little-endian words, zero
padded, masked to the piece length) plus the byte length. The probe
gathers ONE 8-slot bucket row of the ``vhash8`` table per piece and
compares all slots exactly: rank on a hit, -1 on a miss. A miss can be
deliberate (bucket overflow entries are dropped from the table); the host
splice does the oracle's whole-piece dict lookup first, so it is exact.

``vocab_probe8`` is the kernel's wrapper: CUDA tensors run
``csrc/probe.cu`` (``td_vocab_probe8``), which replaces the XLA program of
the JAX package's ``ops/join.vocab_probe8t_chunks`` (no ``pallas_call``;
its 16/48/96-way chunking only worked around the TPU's gather
scheduling); CPU tensors run ``vocab_probe8_plain``. It never falls back
from one to the other.

``vocab_join`` is the same lookup as a sort-merge join against the
vocabulary's whole-piece keys (``join_mode="sort"``): the JAX package runs
it as ``lax.sort`` plus an ``associative_scan``, with no Pallas kernel, so
the port runs it with ``torch.sort``.

``vocab_probe`` is the same lookup against the 4-slot, two-choice table
of ``tables.build_vocab_hash``: two 96-byte row gathers per piece. No
path reads it, so it stays plain torch on every device;
``vocab_probe8_np`` and ``vocab_probe_np`` are numpy oracles of both
probes, for tests.

``vocab_probe_hot`` answers a host-chosen set of hot pieces by compare and
probes only the rest, compacted to a dense prefix by kernel K5+K6 and put
back by K7+K8 (``compact.compact_record`` / ``expand_route``).
"""

from __future__ import annotations

import ctypes
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


def vocab_probe8_plain(qk0, qk1, qk2, qk3, qlen, rows: torch.Tensor,
                       mask: int) -> torch.Tensor:
    """Plain torch version of ``vocab_probe8``: rank of each piece whose
    key words and length match a slot of its bucket row, else -1."""
    a, b = vhash_ab(qk0, qk1, qk2, qk3, qlen)
    h = _mix(a, b, 0, mask)
    r = rows[h]                                          # (..., 48)
    keys = (qk0, qk1, qk2, qk3, qlen)
    hit = torch.ones(r.shape[:-1] + (8,), dtype=torch.bool, device=r.device)
    for j, q in enumerate(keys):
        hit &= r[..., 8 * j : 8 * j + 8] == q.to(torch.int32)[..., None]
    ranks = torch.where(hit, r[..., 40:48], -1)
    return ranks.amax(dim=-1).to(torch.int32)


@lru_cache(maxsize=None)
def _library():
    from .._build import cuda_library

    lib = cuda_library("probe")
    vp = ctypes.c_void_p
    lib.td_vocab_probe8.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong,
                                    vp, ctypes.c_uint, vp, vp]
    lib.td_vocab_probe8.restype = ctypes.c_int
    return lib


def _launch_probe8(qk0, qk1, qk2, qk3, qlen, rows, mask: int):
    from .compact import _check, _on

    lib = _library()
    dev = qlen.device
    out = torch.empty(qlen.shape, dtype=torch.int32, device=dev)
    with _on(dev) as stream:
        rc = lib.td_vocab_probe8(
            qk0.data_ptr(), qk1.data_ptr(), qk2.data_ptr(), qk3.data_ptr(),
            qlen.data_ptr(), qlen.numel(), rows.data_ptr(), mask,
            out.data_ptr(), stream)
    _check(rc, "vocab_probe8")
    vocab_probe8.launches += 1
    return out


def vocab_probe8(qk0, qk1, qk2, qk3, qlen, rows: torch.Tensor,
                 mask: int) -> torch.Tensor:
    """Rank of each piece whose key words and length match a slot of its
    bucket row, else -1. Keys are int32 tensors (uint32 bits), ``qlen``
    int32, all of one shape (any rank), ``rows`` the (mask + 1, 48) int32
    vhash8 table on the same device. CUDA tensors run kernel
    ``td_vocab_probe8``; CPU tensors ``vocab_probe8_plain``."""
    from .compact import _require

    shape = tuple(qlen.shape)
    dev = qlen.device
    if (rows.dim() != 2 or rows.shape[1] != 48
            or rows.shape[0] != mask + 1 or mask & (mask + 1)):
        raise ValueError("rows must be the (mask + 1, 48) vhash8 table")
    for name, q in (("qk0", qk0), ("qk1", qk1), ("qk2", qk2), ("qk3", qk3),
                    ("qlen", qlen)):
        _require(q, name, shape, torch.int32, dev)
    _require(rows, "rows", rows.shape, torch.int32, dev)
    if dev.type == "cuda":
        if rows.data_ptr() % 16:
            raise ValueError("the vhash8 table must be 16-byte aligned")
        if qlen.numel() == 0:
            return torch.empty(shape, dtype=torch.int32, device=dev)
        return _launch_probe8(qk0, qk1, qk2, qk3, qlen, rows, mask)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return vocab_probe8_plain(qk0, qk1, qk2, qk3, qlen, rows, mask)


vocab_probe8.launches = 0


def vocab_probe(qk0, qk1, qk2, qk3, qlen, rows: torch.Tensor,
                mask: int) -> torch.Tensor:
    """Rank of each piece whose key words and length match a slot of its
    first or second bucket row, else -1: the JAX ``join.vocab_probe``.
    Keys are int32 tensors (uint32 bits) or int64 holding uint32 values,
    ``qlen`` int32, ``rows`` the (nb, 24) int32 table of
    ``tables.build_vocab_hash`` on the same device; any leading shape."""
    a, b = vhash_ab(qk0, qk1, qk2, qk3, qlen)
    keys = [to_i32(u32(q)) for q in (qk0, qk1, qk2, qk3)] + [
        qlen.to(torch.int32)]
    out = torch.full(qk0.shape, -1, dtype=torch.int32, device=qk0.device)
    for which in (0, 1):
        r = rows[_mix(a, b, which, mask)]                # (..., 24)
        hit = torch.ones(r.shape[:-1] + (4,), dtype=torch.bool,
                         device=r.device)
        for j, q in enumerate(keys):
            hit &= r[..., 4 * j : 4 * j + 4] == q[..., None]
        vals = torch.where(hit, r[..., 20:24], -1).amax(dim=-1)
        out = torch.where((out < 0) & (vals >= 0), vals, out)
    return out.to(torch.int32)


def vocab_probe8_np(qk, qlen, vhash8_rows, vhash8_mask):
    """Numpy reference of ``vocab_probe8``: ``qk`` (P, 4) uint32 key
    words, ``qlen`` (P,) int32 (for tests)."""
    from ..tables import _mix_hash, _vhash_ab

    a, b = _vhash_ab(qk[:, 0], qk[:, 1], qk[:, 2], qk[:, 3], qlen)
    h = _mix_hash(a, b, 0, vhash8_mask)
    r = vhash8_rows[h]
    ik = qk.view(np.int32).reshape(len(qlen), 4)
    hit = (
        (r[:, 0:8] == ik[:, 0:1]) & (r[:, 8:16] == ik[:, 1:2])
        & (r[:, 16:24] == ik[:, 2:3]) & (r[:, 24:32] == ik[:, 3:4])
        & (r[:, 32:40] == qlen[:, None])
    )
    return np.where(hit, r[:, 40:48], -1).max(axis=1)


def vocab_probe_np(qk, qlen, vhash_rows, vhash_mask):
    """Numpy reference of ``vocab_probe`` (for tests)."""
    from ..tables import _mix_hash, _vhash_ab

    a, b = _vhash_ab(qk[:, 0], qk[:, 1], qk[:, 2], qk[:, 3], qlen)
    out = np.full(len(qlen), -1, np.int32)
    ik = qk.view(np.int32).reshape(len(qlen), 4)
    for which in (0, 1):
        h = _mix_hash(a, b, which, vhash_mask)
        r = vhash_rows[h]
        hit = (
            (r[:, 0:4] == ik[:, 0:1]) & (r[:, 4:8] == ik[:, 1:2])
            & (r[:, 8:12] == ik[:, 2:3]) & (r[:, 12:16] == ik[:, 3:4])
            & (r[:, 16:20] == qlen[:, None])
        )
        vals = np.where(hit, r[:, 20:24], -1).max(axis=1)
        out = np.where((out < 0) & (vals >= 0), vals, out)
    return out


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


def _pack64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int32-bit words as one int64 sort key; equal keys iff both
    words are equal."""
    return (hi.to(torch.int64) << 32) | u32(lo)


def vocab_join(qk0, qk1, qk2, qk3, qlen, vk: torch.Tensor, vlen: torch.Tensor,
               vrank: torch.Tensor) -> torch.Tensor:
    """Rank of each query piece's exact (four key words, length) match
    among the vocabulary's keys, -1 on a miss: the contract of the JAX
    ``join.vocab_join``. Queries are int32 words (uint32 bits) and int32
    lengths of any shape; ``vk`` (V, 4) int32 words, ``vlen``/``vrank``
    (V,). The vocabulary's entries and the queries are sorted together
    by stable sorts, vocabulary first, so each key run starts with its
    vocab entry if there is one; a cummax of the last vocab position
    fills each run, and the queries' ranks are put back in their order."""
    shape = qk0.shape
    dev = qk0.device
    V = vlen.shape[0]
    P = qk0.numel()
    if V == 0:
        return torch.full(shape, -1, dtype=torch.int32, device=dev)
    words = [torch.cat([vk[:, j], q.reshape(-1).to(torch.int32)])
             for j, q in enumerate((qk0, qk1, qk2, qk3))]
    kl = torch.cat([vlen, qlen.reshape(-1)]).to(torch.int64)
    keys = (kl, _pack64(words[2], words[3]), _pack64(words[0], words[1]))
    order = torch.arange(V + P, device=dev)
    for k in keys:                        # least significant first
        _, perm = torch.sort(k[order], stable=True)
        order = order[perm]
    pos = torch.arange(V + P, device=dev)
    brk = pos == 0
    for k in keys:
        ks = k[order]
        brk[1:] |= ks[1:] != ks[:-1]
    run_start = torch.cummax(torch.where(brk, pos, 0), dim=0).values
    last_vocab = torch.cummax(torch.where(order < V, pos, -1), dim=0).values
    found = last_vocab >= run_start
    rank = torch.where(
        found, vrank[order[last_vocab.clamp(min=0)].clamp(max=V - 1)], -1)
    out = torch.empty(P, dtype=torch.int32, device=dev)
    is_query = order >= V
    out[order[is_query] - V] = rank[is_query].to(torch.int32)
    return out.reshape(shape)


# ===========================================================================
# Piece-key compaction in plain torch (the JAX package's XLA forms)
# ===========================================================================


def _mask_words(words, piece_len: torch.Tensor):
    """Key words (int64 holding uint32 values) with the bytes at and
    beyond each piece's length zeroed, as int32 (uint32 bits): word j
    keeps ``clip(len - 4j, 0, 4)`` bytes."""
    out = []
    for j, k in enumerate(words):
        r = torch.clamp(piece_len.to(torch.int64) - 4 * j, 0, 4)
        out.append(to_i32(k & ((1 << (8 * r)) - 1)))
    return out


def _piece_lengths(start_b, n_pieces, nb, live):
    """Each piece's length: the next slot's start minus its own, the last
    live piece ending at ``nb``, 0 on dead slots."""
    pslot = torch.arange(start_b.shape[-1], device=start_b.device)
    nxt_start = _shift_left_slots(start_b, 1)
    end_b = torch.where(pslot == n_pieces - 1, nb, nxt_start)
    return torch.where(live, end_b - start_b, 0)


def compact_piece_keys(starts_char: torch.Tensor, byte_of_char: torch.Tensor,
                       data: torch.Tensor, nbytes, p_cap: int):
    """Piece (start_b, piece_len, k0..k3, n_pieces) from char-level start
    flags by scatters: the JAX ``join.compact_piece_keys``. Shapes (N,)
    or (B, N) with a scalar or (B,) ``nbytes``; outputs int32 of (p_cap,)
    or (B, p_cap), key words carrying uint32 bits, and ``n_pieces``.

    Dead slots hold start_b = nbytes, length 0, keys 0. When n_pieces >
    p_cap every piece past the capacity is written to slot p_cap - 1,
    several writers to one slot (the reference leaves the winner to XLA):
    the caller must fall back, and only slots below p_cap - 2 are
    defined."""
    from .pretokenize import _batched  # pretokenize imports us (compact)

    d, nb, one = _batched(data, nbytes, column=True)
    st = starts_char[None] if one else starts_char
    boc = byte_of_char[None] if one else byte_of_char
    B, N = d.shape
    dev = d.device
    idx = torch.arange(N, device=dev)
    tgt_b = torch.where(st, boc.to(torch.int64), N)
    is_start = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    is_start.scatter_(1, tgt_b, True)
    is_start = is_start[:, :N] & (idx < nb)
    pid = torch.cumsum(is_start, dim=1) - 1
    n_pieces = torch.clamp(pid[:, -1:] + 1, min=0)
    tgt = torch.where(is_start, torch.clamp(pid, max=p_cap - 1), p_cap)

    def comp(vals, fill):
        out = torch.full((B, p_cap + 1), fill, dtype=torch.int64, device=dev)
        return out.scatter_(1, tgt, vals.expand(B, N))[:, :p_cap]

    start_b = comp(idx, 0x7FFFFFFF)
    words = [comp(w, M32) for w in sliding_words(d, nb[:, 0])]
    live = torch.arange(p_cap, device=dev) < n_pieces
    piece_len = _piece_lengths(start_b, n_pieces, nb, live)
    start_b = torch.where(live, start_b, nb)
    out = (start_b.to(torch.int32), piece_len.to(torch.int32),
           *_mask_words(words, piece_len), n_pieces[:, 0].to(torch.int32))
    return tuple(o[0] for o in out) if one else out


def compact_piece_keys_sorted(starts_b: torch.Tensor, data: torch.Tensor,
                              nbytes, p_cap: int):
    """``compact_piece_keys`` from byte-level start flags by one sort: the
    JAX ``join.compact_piece_keys_sorted``. The key is a byte's index at a
    piece start and N + index elsewhere (unique), so the first
    ``n_pieces`` sorted keys are the starts in order, and the four key
    words follow the sort's permutation. Every slot is defined, also on
    overflow. ``p_cap`` is at most N, as in the reference."""
    from .pretokenize import _batched  # pretokenize imports us (compact)

    d, nb, one = _batched(data, nbytes, column=True)
    st = starts_b[None] if one else starts_b
    N = d.shape[1]
    if p_cap > N:
        raise ValueError(f"p_cap {p_cap} exceeds the window length {N}")
    dev = d.device
    idx = torch.arange(N, device=dev)
    live_in = st & (idx < nb)
    n_pieces = live_in.sum(dim=1, keepdim=True)
    ks, perm = torch.sort(torch.where(live_in, idx, N + idx), dim=1)
    ks, perm = ks[:, :p_cap], perm[:, :p_cap]
    live = torch.arange(p_cap, device=dev) < torch.clamp(n_pieces, max=p_cap)
    start_b = torch.where(live, ks, nb)
    piece_len = _piece_lengths(start_b, n_pieces, nb, live)
    words = [torch.gather(w, 1, perm) for w in sliding_words(d, nb[:, 0])]
    out = (start_b.to(torch.int32), piece_len.to(torch.int32),
           *_mask_words(words, piece_len), n_pieces[:, 0].to(torch.int32))
    return tuple(o[0] for o in out) if one else out
