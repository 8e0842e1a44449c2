"""Window-pipeline constants shared by the stages, the trim-aware
finalize of the device engine's windows (``finalize_host``, kernel K4;
``finalize_host_sorted``, its plain torch sort form), and the window
resolver with its device merge of the misses (``resolve_window``)."""

from __future__ import annotations

import torch

SENTINEL = 2**31 - 2  # flat-stream marker for a piece the host splices

# miss-bucket widths of resolve_window's merge rows
W16, W64, W256 = 16, 64, 256


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


def finalize_host_sorted(start_b, piece_len, rank, n_pieces, trim, *,
                         p_cap: int, untrimmed: bool = False):
    """``finalize_host``'s contract with its two compactions (the kept
    pieces' ids, the miss spans) done by one ``torch.sort`` each, in plain
    torch: the JAX ``ops/fused.finalize_host_sorted``. Inputs (p_cap,)
    with scalar counts and trim, or (B, p_cap) with (B,) ones (the trim
    may stay a python int); outputs in the same shapes.

    ``untrimmed``: the caller guarantees trim >= nbytes (complete
    windows), so the kept pieces are the live ones in slot order and the
    flat compaction is the identity: its sort is skipped."""
    one = start_b.dim() == 1
    sb, pl, rk = ((x[None] if one else x) for x in (start_b, piece_len,
                                                     rank))
    dev = sb.device
    npc = torch.as_tensor(n_pieces, device=dev).reshape(-1, 1)
    if isinstance(trim, torch.Tensor):
        trim = trim.reshape(-1, 1)
    pslot = torch.arange(p_cap, device=dev)
    end_b = sb + pl
    live = pslot < torch.clamp(npc, max=p_cap)
    kept = live if untrimmed else live & (end_b <= trim)
    n_kept = kept.sum(dim=1).to(torch.int32)
    consumed = torch.where(kept, end_b, 0).amax(dim=1).to(torch.int32)
    overflow = npc[:, 0] > p_cap
    hit = kept & (rk >= 0)
    miss = kept & (rk < 0)
    ids = torch.where(hit, rk, SENTINEL).to(torch.int32)
    if untrimmed:
        flat = torch.where(kept, ids, -1)
    else:
        _, perm = torch.sort(torch.where(kept, pslot, p_cap + pslot), dim=1)
        flat = torch.where(pslot < n_kept[:, None],
                           torch.gather(ids, 1, perm), -1)
    n_ms = miss.sum(dim=1).to(torch.int32)
    _, perm = torch.sort(torch.where(miss, pslot, p_cap + pslot), dim=1)
    in_ms = pslot < n_ms[:, None]
    ms_s = torch.where(in_ms, torch.gather(sb, 1, perm), 0)
    ms_l = torch.where(in_ms, torch.gather(pl, 1, perm), 0)
    out = (flat.to(torch.int32), n_kept, npc[:, 0].to(torch.int32), n_kept,
           consumed, overflow, ms_s.to(torch.int32), ms_l.to(torch.int32),
           n_ms)
    return tuple(o[0] for o in out) if one else out


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis (int64)."""
    c = torch.cumsum(x, dim=-1)
    return c - x


def _to_width(x: torch.Tensor, width: int, fill: int) -> torch.Tensor:
    """(B, P) -> (B, width): cut, or padded with ``fill``."""
    B, P = x.shape
    if width <= P:
        return x[:, :width]
    pad = torch.full((B, width - P), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def resolve_window(starts_char, byte_of_char, data, nbytes, trim, byte_rank,
                   pair_rows, pair_lut, vk, vlen, vrank, vhash_rows, *,
                   p_cap: int, m16: int, m64: int, m256: int, os_cap: int,
                   mask: int, vhash_mask: int, join_mode: str = "probe",
                   miss_mode: str = "host", rows_out: dict | None = None):
    """The JAX ``ops/fused.resolve_window`` over a batch of windows: from
    char-level piece starts to flat ids, with the misses merged on the
    device (``miss_mode="device"``) or left to the host (``"host"``).

    ``starts_char`` (B, N) bool, ``byte_of_char`` (B, N) int32 (padded
    with the window's length), ``data`` (B, N) uint8, ``nbytes`` and
    ``trim`` (B,) int32 (or python ints), then the ``MergeTables`` fields
    and the vhash8 rows. Returns (flat (B, N), total, n_pieces, n_kept,
    consumed, overflow, span_start, span_len, n_spans), each (B,) or
    (B, ·). ``flat`` holds the ids of the kept pieces (those ending at or
    before ``trim``) in order and -1 beyond ``total``.

    * "host": every miss is a SENTINEL slot; its span is compacted into
      the first ``n_spans`` of p_cap slots (``finalize_host``).
    * "device": misses of at most 16, 64 and 256 bytes are compacted into
      rows of those widths (kernel K4, up to ``m16``/``m64``/``m256``
      rows), gathered from the window and BPE-merged
      (``merge.merge_rows`` with ``pair_lut``); a merged piece yields its
      several ids in place. A piece over 256 bytes is a SENTINEL slot, its
      span compacted into ``os_cap`` slots. ``overflow`` is set when the
      pieces exceed ``p_cap`` or a bucket or ``os_cap`` overflows.

    The piece keys come from kernel K2+K3 (``compact.compact_piece_keys``)
    on the byte-level start flags; the whole-piece lookup is
    ``join.vocab_probe8`` ("probe") or ``join.vocab_join`` ("sort").
    ``rows_out``, a dict, receives under "device" each merge width's
    (B,) count of miss rows (before the cap), for the caller's stats."""
    from .compact import compact_by_mask, compact_piece_keys
    from .join import vocab_join, vocab_probe8
    from .merge import merge_rows

    if join_mode not in ("probe", "sort"):
        raise ValueError(f"join_mode must be 'probe' or 'sort', not "
                         f"{join_mode!r}")
    if miss_mode not in ("host", "device"):
        raise ValueError(f"miss_mode must be 'host' or 'device', not "
                         f"{miss_mode!r}")
    B, N = data.shape
    dev = data.device
    nb = torch.as_tensor(nbytes, device=dev).to(torch.int32).expand(B)
    trim_t = torch.as_tensor(trim, device=dev).to(torch.int64).expand(B)
    idx = torch.arange(N, device=dev)
    # char starts -> byte flags (the char-level compaction's first step)
    tgt = torch.where(starts_char, byte_of_char.to(torch.int64), N)
    flags = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    flags.scatter_(1, tgt, True)
    flags = flags[:, :N] & (idx < nb[:, None])
    sb, pl, k0, k1, k2, k3, n_pieces = compact_piece_keys(
        flags.contiguous(), data, nb.contiguous(), p_cap)
    if join_mode == "sort":
        rank = vocab_join(k0, k1, k2, k3, pl, vk, vlen, vrank)
    else:
        rank = vocab_probe8(k0, k1, k2, k3, pl, vhash_rows, vhash_mask)

    if miss_mode == "host":
        (flat_p, total, n_pieces, n_kept, consumed, overflow, ms_s, ms_l,
         n_ms) = finalize_host(sb, pl, rank, n_pieces, trim_t, p_cap=p_cap)
        flat = _to_width(flat_p, N, -1)
        return (flat, total, n_pieces, n_kept, consumed, overflow, ms_s,
                ms_l, n_ms)

    pslot = torch.arange(p_cap, device=dev)[None, :]
    end_b = sb + pl
    live = pslot < torch.clamp(n_pieces, max=p_cap)[:, None]
    kept = live & (end_b <= trim_t[:, None])
    n_kept = kept.sum(dim=1).to(torch.int32)
    consumed = torch.where(kept, end_b, 0).amax(dim=1).to(torch.int32)
    hit = kept & (rank >= 0)
    miss = kept & (rank < 0)
    f16 = miss & (pl <= W16)
    f64 = miss & (pl > W16) & (pl <= W64)
    f256 = miss & (pl > W64) & (pl <= W256)
    fos = miss & (pl > W256)
    overflow = n_pieces > p_cap

    slots = pslot.expand(B, p_cap).to(torch.int32).contiguous()
    counts = torch.where(hit | fos, 1, 0)
    counts = torch.cat([counts, torch.zeros((B, 1), dtype=counts.dtype,
                                            device=dev)], dim=1)
    merged = []
    for flag, cap, width in ((f16, m16, W16), (f64, m64, W64),
                             (f256, m256, W256)):
        n_rows = flag.sum(dim=1)
        if rows_out is not None:
            rows_out[width] = n_rows
        overflow = overflow | (n_rows > cap)
        s_r, l_r, src = (_to_width(a, cap, 0) for a in compact_by_mask(
            [sb, pl, slots], flag, fill=0))
        src = torch.where(torch.arange(cap, device=dev)[None, :]
                          < n_rows[:, None], src, p_cap).to(torch.int64)
        cols = torch.arange(width, device=dev)
        gidx = torch.clamp(s_r[:, :, None].to(torch.int64) + cols, 0, N - 1)
        l_w = torch.clamp(l_r, max=width)
        rows_b = torch.where(cols < l_w[:, :, None],
                             torch.gather(data, 1, gidx.reshape(B, -1))
                             .reshape(B, cap, width), 0).to(torch.uint8)
        tok, cnt = merge_rows(rows_b.reshape(B * cap, width).contiguous(),
                              l_w.reshape(-1).to(torch.int32).contiguous(),
                              byte_rank, pair_rows, mask, pair_lut)
        counts.scatter_(1, src, cnt.reshape(B, cap).to(counts.dtype))
        merged.append((tok.reshape(B, cap, width), src))
    counts = torch.where(kept, counts[:, :p_cap], 0)
    out_pos = _exclusive_cumsum(counts)
    total = counts.sum(dim=1).to(torch.int32)

    flat = torch.full((B, N + 1), -1, dtype=torch.int32, device=dev)
    single = hit | fos
    flat.scatter_(1, torch.where(single, out_pos, N).clamp(max=N),
                  torch.where(fos, SENTINEL, rank).to(torch.int32))
    out_ext = torch.cat([out_pos, torch.zeros((B, 1), dtype=out_pos.dtype,
                                              device=dev)], dim=1)
    for tok, src in merged:
        row_out = torch.gather(out_ext, 1, src)           # (B, cap)
        live_tok = tok >= 0
        col_rank = _exclusive_cumsum(live_tok.to(torch.int64))
        fidx = torch.where(live_tok, row_out[:, :, None] + col_rank, N)
        flat.scatter_(1, fidx.clamp(max=N).reshape(B, -1), tok.reshape(B, -1))
    flat = flat[:, :N].contiguous()

    n_os = fos.sum(dim=1).to(torch.int32)
    overflow = overflow | (n_os > os_cap)
    os_s, os_l = (_to_width(a, os_cap, 0)
                  for a in compact_by_mask([sb, pl], fos, fill=0))
    return (flat, total, n_pieces, n_kept, consumed, overflow,
            os_s.contiguous(), os_l.contiguous(), n_os)
