"""Window-pipeline constants shared by the stages, and the trim-aware
finalize of the device engine's windows."""

from __future__ import annotations

import torch

SENTINEL = 2**31 - 2  # flat-stream marker for a piece the host splices


def caps_for(n: int, bytes_per_piece: float = 3.0) -> dict[str, int]:
    """Static capacities for a window of n bytes: piece slots and per-width
    miss-row capacities (same values as the JAX package's
    ``ops/fused.caps_for``).

    ``bytes_per_piece`` sets the piece-slot capacity; a denser window
    sets the overflow flag and takes the exact host path, so a wrong
    guess costs time, never correctness."""
    return dict(
        p_cap=max(512, -(-int(n / bytes_per_piece) // 128) * 128),
        m16=max(256, n // 16),
        m64=max(64, n // 128),
        m256=max(32, n // 1024),
        os_cap=128,
    )


def finalize_host(start_b, piece_len, rank, n_pieces, trim, *, p_cap: int):
    """Final assembly of safe-cut windows (the contract of the JAX
    ``ops/fused.finalize_host`` and ``finalize_host_sorted``), batched.

    Inputs are (B, p_cap) int32 piece arrays from
    ``compact.compact_piece_keys`` plus the probe's ranks, (B,) piece
    counts and the trim: a python int, or a (B,) tensor. A live piece is
    kept when it ends at or before the trim. Returns (flat, total,
    n_pieces, n_kept, consumed, overflow, miss_start, miss_len, n_miss):
    ``flat`` holds the kept pieces' ranks in order, SENTINEL where the
    probe missed and -1 beyond ``total``; the miss spans are compacted
    into the first ``n_miss`` slots (0 beyond). Both compactions run
    kernel K4 (``compact.compact_by_mask``)."""
    from .compact import compact_by_mask  # compact imports this module

    dev = start_b.device
    pslot = torch.arange(p_cap, device=dev)[None, :]
    if isinstance(trim, torch.Tensor):
        trim = trim.reshape(-1, 1)
    end_b = start_b + piece_len
    live = pslot < torch.clamp(n_pieces, max=p_cap)[:, None]
    kept = live & (end_b <= trim)
    n_kept = kept.sum(dim=1).to(torch.int32)
    consumed = torch.where(kept, end_b, 0).amax(dim=1).to(torch.int32)
    overflow = n_pieces > p_cap
    hit = kept & (rank >= 0)
    miss = kept & (rank < 0)
    n_ms = miss.sum(dim=1).to(torch.int32)
    ids = torch.where(hit, rank, SENTINEL).to(torch.int32)
    (flat,) = compact_by_mask([ids], kept, fill=-1)
    ms_s, ms_l = compact_by_mask([start_b, piece_len], miss, fill=0)
    return (flat, n_kept, n_pieces, n_kept, consumed, overflow, ms_s, ms_l,
            n_ms)
