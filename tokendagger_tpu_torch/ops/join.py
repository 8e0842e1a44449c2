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
"""

from __future__ import annotations

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
