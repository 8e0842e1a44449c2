"""The device BPE merge of packed pretoken rows, and 32-bit hash mixing on
torch tensors.

Counterpart of the JAX package's ``ops/merge.py``. A batch of pretokens
is packed into (R, C) byte rows; each row repeatedly merges its leftmost
minimum-rank adjacent pair until no pair has a rank, exactly as the
sequential algorithm (``hostengine.byte_pair_merge``) does piece by
piece. During a merge every part is a vocab token, so the rank of two
adjacent parts is a lookup keyed by their two ids in the pair-merge
table (``tables.PairTable``), and that rank *is* the merged part's id.

* ``pair_lookup``, ``merge_rows_local`` and ``merge_rows_from_state`` are
  the plain torch versions, with the JAX functions' contracts: ``tok``
  (R, C) int32 holds each live part's id at its first byte's slot and -1
  at dead slots (live slots in slot order are the ids), ``counts`` (R,)
  the live parts per row. First-round pair ranks come from ``pair_lut``
  when one is given, else from the pair table.
* ``merge_rows`` is the kernel's wrapper: CUDA tensors run
  ``csrc/merge.cu`` (``td_merge_rows``), which replaces the XLA
  ``lax.while_loop`` of ``merge_rows_from_state``; CPU tensors the plain
  loop. It never falls back from one to the other.

torch has no usable uint32 arithmetic (shifts and adds raise on the CPU),
so 32-bit words ride in int64 tensors holding values in [0, 2**32), and
every product is formed from 16-bit halves so that no intermediate leaves
the int64 range."""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..tables import _MIX, MAX_RANK

M32 = 0xFFFFFFFF
MAX = int(MAX_RANK)


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits unsigned."""
    return x.to(torch.int64) & M32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) (int64) and a constant c."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _mix(a: torch.Tensor, b: torch.Tensor, which: int, mask: int) -> torch.Tensor:
    """uint32 multiply-xor mix; bit-identical to tables._mix_hash. a, b are
    any integer tensors (their low 32 bits are used); returns int64."""
    c1, c2, c3 = _MIX[which]
    h = (mul32(u32(a), c1) + mul32(u32(b), c2)) & M32
    h = h ^ (h >> 16)
    h = mul32(h, c3)
    h = h ^ (h >> 15)
    return h & mask


# ===========================================================================
# Plain versions
# ===========================================================================


def pair_lookup(rows: torch.Tensor, mask: int, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """rank(bytes(a) + bytes(b)) or MAX_RANK; ``a``, ``b`` int32 of any
    shape, ``rows`` the (nb, 12) pair table. A negative id (a dead slot)
    always misses."""
    out = torch.full(a.shape, MAX, dtype=torch.int32, device=a.device)
    for which in (0, 1):
        r = rows[_mix(a, b, which, mask)]                  # (..., 12)
        hit = (r[..., 0:4] == a[..., None]) & (r[..., 4:8] == b[..., None])
        vals = torch.where(hit, r[..., 8:12], -1).amax(dim=-1)
        out = torch.where((out == MAX) & (vals >= 0), vals, out)
    return torch.where((a < 0) | (b < 0), MAX, out).to(torch.int32)


def _first_state(byte_buf, lengths, byte_rank, rows, mask, pair_lut):
    """(tok0, pr0, lens) of ``merge_rows_local``: the byte ids and the
    first-round pair ranks, lengths clamped to [0, C]."""
    C = byte_buf.shape[1]
    cols = torch.arange(C, device=byte_buf.device)[None, :]
    lens = lengths.to(torch.int64).clamp(0, C)[:, None]
    b = byte_buf.to(torch.int64)
    tok0 = torch.where(cols < lens, byte_rank[b], -1).to(torch.int32)
    if pair_lut is not None:
        b1 = torch.roll(b, -1, dims=1)
        pr0 = pair_lut.reshape(-1)[b * 256 + b1]
    else:
        pr0 = pair_lookup(rows, mask, tok0, torch.roll(tok0, -1, dims=1))
    pr0 = torch.where(cols < lens - 1, pr0, MAX).to(torch.int32)
    return tok0, pr0, lens[:, 0].to(torch.int32)


def merge_rows_local(byte_buf: torch.Tensor, lengths: torch.Tensor,
                     byte_rank: torch.Tensor, rows: torch.Tensor, *,
                     mask: int, pair_lut: torch.Tensor | None = None):
    """Plain torch BPE merge of every row. ``byte_buf`` (R, C) uint8
    (zero-padded pretoken bytes), ``lengths`` (R,) int32 (0 = an empty
    row), ``byte_rank`` (256,) int32, ``rows`` the (nb, 12) pair table
    with bucket ``mask``, ``pair_lut`` an optional (256, 256) int32.
    Returns (tok (R, C) int32, counts (R,) int32)."""
    tok0, pr0, lens = _first_state(byte_buf, lengths, byte_rank, rows, mask,
                                   pair_lut)
    return merge_rows_from_state(tok0, pr0, lens, rows, mask=mask)


def merge_rows_from_state(tok0: torch.Tensor, pr0: torch.Tensor,
                          lengths: torch.Tensor, rows: torch.Tensor, *,
                          mask: int):
    """The merge loop from a given first-round state: ``tok0`` (R, C)
    int32 ids (-1 dead), ``pr0`` (R, C) int32 rank of the pair starting
    at each slot (MAX_RANK if none), ``lengths`` (R,). Each iteration
    merges, in every row that still has a pair, its leftmost minimum-rank
    pair and looks up the two pairs around the merged part; the host
    reads whether any row is left after each one."""
    R, C = tok0.shape
    dev = tok0.device
    END = C
    cols = torch.arange(C, device=dev)[None, :]
    lens = lengths.to(torch.int64)[:, None]

    def sentinel(x, val):
        """``x`` with column END appended: the "no part" slot (id -1, no
        pair, no neighbours), which writes aimed at END land on."""
        col = torch.full((R, 1), val, dtype=x.dtype, device=dev)
        return torch.cat([x, col], dim=1)

    tok = sentinel(tok0.to(torch.int32), -1)
    pr = sentinel(pr0.to(torch.int32), MAX)
    nxt = sentinel(torch.where(cols < lens - 1, cols + 1, END), END)
    prv = sentinel(torch.where((cols > 0) & (cols < lens), cols - 1, END),
                   END)
    while R and C:
        b = torch.argmin(pr, dim=1)          # leftmost minimum
        v = pr.gather(1, b[:, None])[:, 0]
        act = torch.nonzero(v != MAX).flatten()
        if act.numel() == 0:
            break
        v, b = v[act], b[act]
        b2 = nxt[act, b]                     # right part of the pair
        b3 = nxt[act, b2]                    # part after the pair (or END)
        p = prv[act, b]                      # part before the pair (or END)
        t3 = tok[act, b3]
        tp = tok[act, p]
        tok[act, b] = v                      # the pair's rank is its id
        tok[act, b2] = -1
        nxt[act, b] = b3
        prv[act, b3] = b
        pr[act, b2] = MAX
        pr[act, b] = pair_lookup(rows, mask, v, t3)
        pr[act, p] = pair_lookup(rows, mask, tp, v)
        # restore the sentinel column after writes aimed at END
        tok[:, END] = -1
        pr[:, END] = MAX
        nxt[:, END] = END
        prv[:, END] = END
    tok = tok[:, :C].contiguous()
    return tok, (tok >= 0).sum(dim=1, dtype=torch.int32)


# ===========================================================================
# Kernel
# ===========================================================================


@lru_cache(maxsize=None)
def _library():
    from .._build import cuda_library

    lib = cuda_library("merge")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.td_merge_rows.argtypes = [vp, vp, i, i, vp, vp, ctypes.c_uint, vp,
                                  vp, vp, vp]
    lib.td_merge_rows.restype = i
    lib.td_merge_lanes.argtypes = [i, i]
    lib.td_merge_lanes.restype = i
    lib.td_l2_chase.argtypes = [vp, i, vp, vp]
    lib.td_l2_chase.restype = i
    return lib


def _launch(byte_buf, lengths, byte_rank, rows, mask: int, pair_lut):
    from .compact import _check, _on

    lib = _library()
    R, C = byte_buf.shape
    dev = byte_buf.device
    tok = torch.empty((R, C), dtype=torch.int32, device=dev)
    counts = torch.empty((R,), dtype=torch.int32, device=dev)
    with _on(dev) as stream:
        rc = lib.td_merge_rows(
            byte_buf.data_ptr(), lengths.data_ptr(), R, C,
            byte_rank.data_ptr(), rows.data_ptr(), mask,
            None if pair_lut is None else pair_lut.data_ptr(),
            tok.data_ptr(), counts.data_ptr(), stream)
    _check(rc, "merge_rows")
    merge_rows.launches += 1
    return tok, counts


def merge_rows(byte_buf: torch.Tensor, lengths: torch.Tensor,
               byte_rank: torch.Tensor, rows: torch.Tensor, mask: int,
               pair_lut: torch.Tensor | None = None):
    """BPE-merge every row (the contract of ``merge_rows_local``). CUDA
    tensors run kernel ``td_merge_rows``; CPU tensors the plain loop.
    ``C`` is at most 256."""
    from .compact import _require

    if byte_buf.dim() != 2:
        raise ValueError("byte_buf must be (R, C)")
    R, C = byte_buf.shape
    dev = byte_buf.device
    if not 1 <= C <= 256:
        raise ValueError(f"row width must be 1..256, got {C}")
    if (rows.dim() != 2 or rows.shape[1] != 12
            or rows.shape[0] != mask + 1 or mask & (mask + 1)):
        raise ValueError("rows must be the (mask + 1, 12) pair table")
    _require(byte_buf, "byte_buf", (R, C), torch.uint8, dev)
    _require(lengths, "lengths", (R,), torch.int32, dev)
    _require(byte_rank, "byte_rank", (256,), torch.int32, dev)
    _require(rows, "rows", rows.shape, torch.int32, dev)
    if pair_lut is not None:
        _require(pair_lut, "pair_lut", (256, 256), torch.int32, dev)
    if dev.type == "cuda":
        if rows.data_ptr() % 16:
            raise ValueError("the pair table must be 16-byte aligned")
        if R == 0:
            return (torch.empty((0, C), dtype=torch.int32, device=dev),
                    torch.empty((0,), dtype=torch.int32, device=dev))
        return _launch(byte_buf, lengths, byte_rank, rows, mask, pair_lut)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return merge_rows_local(byte_buf, lengths, byte_rank, rows, mask=mask,
                            pair_lut=pair_lut)


merge_rows.launches = 0


def lanes_per_row(R: int, C: int) -> int:
    """The lanes ``td_merge_rows`` gives each row of an (R, C) call (32,
    8 or 4; the note in ``csrc/merge.cu``). Needs the built library."""
    return _library().td_merge_lanes(R, C)


def l2_chase_ns(n: int = 1 << 20, steps: int = 1 << 16, seed: int = 0,
                device="cuda") -> float:
    """Nanoseconds of one dependent read from L2 on the card: one thread
    follows a random cycle over an ``n``-entry int32 table (4 MB by
    default, resident in the 50 MB L2 after a first walk) for ``steps``
    reads, timed with CUDA events. The latency floor of the merge, whose
    row merges are a chain of such reads."""
    import numpy as np

    from .compact import _check, _on

    perm = np.random.default_rng(seed).permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[perm] = np.roll(perm, -1)
    table = torch.as_tensor(nxt, device=device)
    out = torch.empty(1, dtype=torch.int32, device=table.device)
    lib = _library()
    times = []
    with _on(table.device) as stream:
        for rep in range(4):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            _check(lib.td_l2_chase(table.data_ptr(), steps, out.data_ptr(),
                                   stream), "l2_chase")
            e.record()
            e.synchronize()
            if rep:                      # the first walk fills the L2
                times.append(s.elapsed_time(e) * 1e6 / steps)
    return min(times)
