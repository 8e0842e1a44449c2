"""Window-batch harness of the device pipeline: the JAX package's
``resident.run_resident`` on the card.

``run_resident`` stages ``n_windows`` char-aligned windows of a corpus on
the device, runs one batch of ``batch`` of them through the pipeline
``reps`` times, and reports the device time of each stage, the wall rate,
the piece count and whether the ids equal the host engine's. Two of the
reference's batched pipelines are ported:

* "general" (any UTF-8; ``impl="auto"`` takes it when a window holds a
  multi-byte char): the decode ``pretokenize.utf8_decode_tiles`` (K9,
  K5+K6), the piece starts ``bitplane.piece_starts_chars`` (K1, or with
  the hot codepoints K5+K6, K7+K8 and K1's class-word entry), the
  char-to-byte expansion ``pretokenize.expand_starts_replay`` (K7+K8),
  the piece keys ``compact.compact_piece_keys`` (K2+K3), the probe
  (``join.vocab_probe8``, or ``join.vocab_probe_hot`` with K5+K6 and
  K7+K8) and ``compact.finalize`` (K4);
* the fused ASCII pipeline (``impl="ascii-sort"``, ``starts_impl=
  "bits-pallas"``, ``compact_impl="butterfly"``): the stages of
  ``ResidentStream.pipeline``.

The host side is the reference's: the windowing and char alignment, the
auto piece capacity from exact host piece counts, the hot piece and hot
codepoint sets (``Counter.most_common`` order), the char capacity, the
overflow flags of both hot routes ORed into finalize's, and the check
against the host engine, in which an overflowed window counts as a
mismatch. The reference's four probes return the same ranks; the port has
one probe and reports the name it was given.

Device time per stage comes from CUDA events around the stages of each
timed repetition (the reference parses a profiler trace). On the CPU there
is no device: ``stage_us`` is empty and ``device_ms`` 0, as the reference
reports off the TPU.
"""

from __future__ import annotations

import gc
import time
from collections import Counter
from dataclasses import asdict, dataclass

import numpy as np
import torch

from .convert import tables_from_ranks
from .hostengine import HostEngine, byte_pair_merge
from .ops.bitplane import piece_starts_bits, piece_starts_chars
from .ops.compact import compact_piece_keys, finalize
from .ops.fused import SENTINEL, caps_for
from .ops.join import piece_key_words, vocab_probe8, vocab_probe_hot
from .ops.pretokenize import expand_starts_replay, utf8_decode_tiles
from .utils.windows import char_align


@dataclass
class ResidentResult:
    window_bytes: int
    n_windows: int
    reps: int
    calibration_ms: float       # trivial launch + synchronize
    device_ms: float            # device time per batch (CUDA events)
    kernel_mbps: float          # batch*window_bytes / device_ms
    stage_us: dict              # device µs per stage per batch
    wall_ms: float              # wall clock per batch incl. the final read
    wall_mbps: float
    total_tokens: int
    match_host: bool            # ids bit-identical to the host engine
    batch: int = 1              # windows per batch
    impl: str = "scatter"       # pipeline (general / ascii-sort)
    starts_impl: str = "jnp"    # piece-start formulation
    compact_impl: str = "sort"  # piece compaction
    probe_impl: str = "transposed"  # probe name given, or "hot"
    cap_bpp: float = 3.0        # piece-slot sizing (bytes/piece)
    overlap: dict | None = None  # H2D/compute overlap trial
    # windows whose piece count exceeded p_cap (or a hot route's u_cap):
    # they take the exact host route, and count as mismatches here
    overflow_windows: int = 0
    # hot-piece probe routing: count, compacted capacity, coverage
    probe_hot: dict | None = None

    def to_dict(self):
        return asdict(self)


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"run_resident: {what} is not ported (ROADMAP queue 1 item {item})")


def _hot_pieces(h_sizer, win_bytes, ranks_dict, p_tight):
    """The reference's hot-piece gate (resident.py:209-257): the 128 most
    common pieces of at most 16 bytes, if they cover enough. Returns the
    probe_hot config or None, and the piece capacity."""
    win_pieces = []
    for b in win_bytes:
        txt = b.decode("utf-8")
        win_pieces.append([txt[a:e].encode("utf-8")
                           for a, e in h_sizer.split_spans(txt)])
    pc: Counter = Counter()
    for pieces in win_pieces:
        pc.update(p for p in pieces if len(p) <= 16)
    tot0 = sum(pc.values()) or 1
    hot_list = []
    for p, cnt in pc.most_common(128):
        if cnt / tot0 < 0.0002 and len(hot_list) >= 32:
            break
        hot_list.append(p)
    hot_set = frozenset(hot_list)
    unknowns = [sum(1 for p in pieces if p not in hot_set)
                for pieces in win_pieces]
    max_unknown = max(unknowns, default=0)
    tot = sum(len(p) for p in win_pieces) or 1
    coverage = 1.0 - sum(unknowns) / tot
    u_tight = max(4096, -(-(max_unknown + 128) // 128) * 128)
    p_tile = max(32768, -(-p_tight // 32768) * 32768)
    if hot_list and coverage >= 0.3 and u_tight <= (7 * p_tile) // 10:
        return dict(
            hot_keys=tuple(piece_key_words(p) for p in hot_list),
            hot_ranks=tuple(ranks_dict.get(p, -1) for p in hot_list),
            u_cap=u_tight,
            coverage=round(coverage, 4),
        ), p_tile
    return None, p_tight


def _char_capacity(N: int, max_chars: int, cap_auto: bool) -> int:
    """The general pipeline's char slots (resident.py:467-482)."""
    if cap_auto:
        return min(N, max(4096, -(-int(max_chars * 1.02 + 32) // 4096)
                          * 4096))
    for cand in (N // 4, 5 * N // 16, 3 * N // 8, N // 2, 5 * N // 8,
                 3 * N // 4):
        if cand % 4096 == 0 and max_chars <= cand:
            return cand
    return N


def _hot_codepoints(win_bytes, N: int, c_cap: int):
    """The reference's hot-codepoint gate (resident.py:494-524): the 32
    most common codepoints, if the rest fit in 3/4 of the tile-rounded
    char slots. Returns (hot_cps, u_cap, c_cap), hot_cps None when the
    gate is shut."""
    hist: Counter = Counter()
    win_cps = []
    for b in win_bytes:
        wcp = np.frombuffer(b.decode("utf-8").encode("utf-32-le"),
                            np.uint32).astype(np.int32)
        win_cps.append(wcp)
        vals, cnts = np.unique(wcp, return_counts=True)
        hist.update(dict(zip(vals.tolist(), cnts.tolist())))
    hot = np.asarray([v for v, _ in hist.most_common(32)], np.int32)
    max_unknown = max((int((~np.isin(wcp, hot)).sum()) for wcp in win_cps),
                      default=0)
    u_tight = max(4096, -(-(max_unknown + 128) // 128) * 128)
    c_cap32 = min(N, -(-c_cap // 32768) * 32768)
    if len(hot) and u_tight <= (3 * c_cap32) // 4:
        return tuple(int(v) for v in hot), u_tight, c_cap32
    return None, None, c_cap


def run_resident(
    ranks: dict[bytes, int],
    specials: dict[str, int],
    pattern: str,
    corpus: bytes,
    *,
    window: int = 1 << 20,
    n_windows: int = 8,
    reps: int = 32,
    trials: int = 1,  # the reference's signature; one trial only
    verify: bool = True,
    join_mode: str = "probe",  # the reference's; "probe" only
    miss_mode: str = "host",
    batch: int = 1,
    impl: str = "auto",
    starts_impl: str = "jnp",
    compact_impl: str = "sort",
    probe_impl: str = "transposed",
    cap_bytes_per_piece: float = 3.0,
    overlap_trial: bool = True,
    profile: str = "llama4",
    device: str | torch.device = "cuda",
) -> ResidentResult:
    """Run the batched device pipeline over windows of ``corpus`` and
    return a ``ResidentResult`` (see the module doc). Arguments are the
    reference's plus ``device``: the card by default (raises without
    one), ``"cpu"`` for the kernels' plain versions.

    Ported: ``batch > 1`` with ``impl`` "general" (or "auto" on multi-byte
    windows), and the fused ASCII pipeline. ``cap_bytes_per_piece`` 0
    sizes the piece slots from exact host piece counts, and with
    ``probe_impl="chunks"`` routes the hot pieces (and on the general
    pipeline, windows a multiple of 32768, the hot codepoints)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if miss_mode != "host":
        raise _not_ported(f"miss_mode={miss_mode!r} (device BPE merge)", 13)
    if join_mode != "probe":
        raise _not_ported(f"join_mode={join_mode!r} (device BPE merge)", 13)
    if trials != 1:
        raise ValueError("run_resident runs one trial (the reference "
                         "ignores trials)")
    on_card = dev.type == "cuda"
    N = window

    # ---- staging: char-aligned windows (resident.py:143-173) -----------
    win_bytes: list[bytes] = []
    bufs = []
    all_ascii = True
    max_chars = 0
    for w in range(n_windows):
        lo = (w * N) % max(1, len(corpus) - N)
        arr = char_align(np.frombuffer(corpus[lo : lo + N], np.uint8))
        buf = np.zeros(N, dtype=np.uint8)
        buf[: len(arr)] = arr
        all_ascii = all_ascii and not (buf & 0x80).any()
        max_chars = max(max_chars, int(((arr & 0xC0) != 0x80).sum()))
        win_bytes.append(arr.tobytes())
        bufs.append(buf)

    if impl == "auto":
        if all_ascii:
            impl = "ascii-sort"
        elif batch > 1:
            impl = "general"
        else:
            impl = "sort"
    if impl == "general":
        starts_impl = "bits-pallas"
        compact_impl = "butterfly"
    if batch <= 1:
        raise _not_ported("the single-window pipeline (batch=1)", 12)
    if compact_impl == "butterfly" and impl not in ("ascii-sort", "general"):
        compact_impl = "sort"
    fused_ascii = (impl == "ascii-sort" and starts_impl == "bits-pallas"
                   and compact_impl == "butterfly")
    if impl != "general" and not fused_ascii:
        raise _not_ported(
            f"impl={impl!r} with starts_impl={starts_impl!r}, "
            f"compact_impl={compact_impl!r}", 12)

    # ---- capacities (resident.py:175-263) ------------------------------
    cap_auto = not cap_bytes_per_piece
    probe_hot_cfg = None
    if cap_auto:
        h_sizer = HostEngine(pattern, ranks, specials)
        max_pieces = max((len(h_sizer.split_spans(b.decode("utf-8")))
                          for b in win_bytes), default=1)
        p_tight = max(512, -(-int(max_pieces * 1.02 + 8) // 128) * 128)
        cap_bytes_per_piece = round(N / p_tight, 2)
        if probe_impl == "chunks":
            probe_hot_cfg, p_tight = _hot_pieces(h_sizer, win_bytes,
                                                 dict(ranks), p_tight)
            if probe_hot_cfg is not None:
                cap_bytes_per_piece = round(N / p_tight, 2)
    caps = caps_for(N, bytes_per_piece=cap_bytes_per_piece)
    if cap_auto:
        caps["p_cap"] = p_tight
    p_cap = caps["p_cap"]

    hot_cps = u_cap = None
    c_cap = N
    if impl == "general":
        c_cap = _char_capacity(N, max_chars, cap_auto)
        if cap_auto and N % 32768 == 0:
            hot_cps, u_cap, c_cap = _hot_codepoints(win_bytes, N, c_cap)

    tables = tables_from_ranks(ranks, device=dev)
    rows, vmask = tables.vhash8_rows, tables.vhash8_mask

    def probe(k0, k1, k2, k3, pl):
        """rank, and the hot route's overflow flags (or None)."""
        if probe_hot_cfg is None:
            return vocab_probe8(k0, k1, k2, k3, pl, rows, vmask), None
        return vocab_probe_hot(
            k0, k1, k2, k3, pl, rows, vmask,
            hot_keys=probe_hot_cfg["hot_keys"],
            hot_ranks=probe_hot_cfg["hot_ranks"],
            u_cap=probe_hot_cfg["u_cap"])

    def no_tick(name: str) -> None:
        pass

    def pipeline(d, nb, tick=no_tick):
        """One batch through the stages; ``tick(stage)`` after each.
        Returns finalize's 9-tuple with every overflow ORed into [5]."""
        flags = []
        if impl == "general":
            cp, lead, m, route = utf8_decode_tiles(d, nb, c_cap=c_cap)
            tick("decode")
            if hot_cps is not None:
                st_c, cls_ovf = piece_starts_chars(
                    cp, m, profile=profile, hot_cps=hot_cps, u_cap=u_cap)
                flags.append(cls_ovf)
            else:
                st_c = piece_starts_chars(cp, m, profile=profile)
            tick("starts")
            starts = expand_starts_replay(st_c, lead, route)
            tick("expand")
            keys = compact_piece_keys(starts, d, nb, p_cap)
        else:
            words = piece_starts_bits(d, nb, profile=profile)
            tick("starts")
            keys = compact_piece_keys(words, d, nb, p_cap, packed=True)
        tick("compact")
        sb, pl, k0, k1, k2, k3, npc = keys
        rank, p_ovf = probe(k0, k1, k2, k3, pl)
        tick("probe")
        out = finalize(sb, pl, rank, npc, p_cap=p_cap)
        tick("finalize")
        if p_ovf is not None:
            flags.append(p_ovf)
        for ovf in flags:
            out = out[:5] + (out[5] | ovf,) + out[6:]
        return out

    h_stk = torch.from_numpy(np.stack([bufs[i % n_windows]
                                       for i in range(batch)]))
    h_nb = torch.tensor([len(win_bytes[i % n_windows]) for i in range(batch)],
                        dtype=torch.int32)
    stk_dev, stk_nb = h_stk.to(dev), h_nb.to(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # calibration: a trivial launch and synchronize
    xcal = torch.arange(1024, dtype=torch.int32, device=dev)
    (xcal * 3 + 1).sum()
    sync()
    t0 = time.perf_counter()
    for _ in range(20):
        (xcal * 3 + 1).sum()
        sync()
    calibration_ms = (time.perf_counter() - t0) / 20 * 1e3

    # warm-up: builds the kernels, fills the allocator's pools; then a
    # collection, so that the host clocks below do not pay for the
    # staging's garbage (the hot-piece count makes millions of objects)
    pipeline(stk_dev, stk_nb)
    sync()
    gc.collect()

    # ---- timed repetitions: CUDA events between the stages -------------
    marks: list = []

    def tick(name: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    t0 = time.perf_counter()
    last = None
    for _ in range(reps):
        if on_card:
            tick("")
            last = pipeline(stk_dev, stk_nb, tick)
        else:
            last = pipeline(stk_dev, stk_nb)
    total_tokens = int(last[1].sum())   # the one read that drains the queue
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    overflow_windows = int(last[5].sum())
    stage_tot: dict[str, float] = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if name:
            stage_tot[name] = stage_tot.get(name, 0.0) + a.elapsed_time(b) * 1e3
    stage_us = {k: round(v / reps, 2) for k, v in sorted(stage_tot.items())}
    device_ms = sum(stage_tot.values()) / reps / 1e3

    # ---- H2D/compute overlap trial (resident.py:728-778) ----------------
    overlap_stats = None
    if overlap_trial:
        overlap_stats = _overlap_trial(pipeline, bufs, win_bytes, batch,
                                       n_windows, N, dev)

    match = True
    if verify:
        out = [o.cpu().numpy() for o in pipeline(stk_dev, stk_nb)]
        host = HostEngine(pattern, ranks, specials)
        rdict = dict(ranks)
        match = all(
            _check_window(tuple(o[b] for o in out),
                          h_stk[b, : int(h_nb[b])].numpy().tobytes(), host,
                          rdict)
            for b in range(batch))

    per_batch_bytes = N * batch
    return ResidentResult(
        window_bytes=N,
        n_windows=n_windows,
        reps=reps,
        calibration_ms=round(calibration_ms, 3),
        device_ms=round(device_ms, 4),
        kernel_mbps=round(per_batch_bytes / 1e6 / (device_ms / 1e3), 2)
        if device_ms else 0.0,
        stage_us=stage_us,
        wall_ms=round(wall_ms, 3),
        wall_mbps=round(per_batch_bytes / 1e6 / (wall_ms / 1e3), 2),
        total_tokens=total_tokens,
        match_host=match,
        batch=batch,
        impl=impl,
        starts_impl=starts_impl,
        compact_impl=compact_impl,
        probe_impl="hot" if probe_hot_cfg is not None else probe_impl,
        cap_bpp=cap_bytes_per_piece,
        overlap=overlap_stats,
        overflow_windows=overflow_windows,
        probe_hot=(
            dict(n_hot=len(probe_hot_cfg["hot_keys"]),
                 u_cap=probe_hot_cfg["u_cap"],
                 coverage=probe_hot_cfg["coverage"])
            if probe_hot_cfg is not None else None
        ),
    )


def _overlap_trial(pipeline, bufs, win_bytes, batch, n_windows, N, dev):
    """Three wall protocols over 4 fresh batches: pure staging, streaming
    (batch k+1's copy issued before batch k's pipeline) and serial. On the
    card the batches sit in pinned host buffers and are copied on a side
    stream, as ``ResidentStream`` stages them."""
    n_stream = 4
    on_card = dev.type == "cuda"
    bats = []
    for k in range(n_stream):
        idx = [(k + i) % n_windows for i in range(batch)]
        d = torch.from_numpy(np.stack([bufs[j] for j in idx]))
        nb = torch.tensor([len(win_bytes[j]) for j in idx], dtype=torch.int32)
        bats.append((d.pin_memory(), nb.pin_memory()) if on_card else (d, nb))
    copy_stream = torch.cuda.Stream(dev) if on_card else None

    def stage(k):
        d, nb = bats[k]
        if not on_card:
            return d.clone(), nb.clone(), None
        with torch.cuda.stream(copy_stream):
            dd = d.to(dev, non_blocking=True)
            nn = nb.to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy_stream)
        return dd, nn, ev

    def run(dd, nn, ev):
        if ev is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            dd.record_stream(cur)
            nn.record_stream(cur)
        return pipeline(dd, nn)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    staged = [stage(k) for k in range(n_stream)]
    sync()
    t_transfer = time.perf_counter() - t0
    del staged
    t0 = time.perf_counter()
    cur = stage(0)
    outs = []
    for k in range(n_stream):
        nxt = stage(k + 1) if k + 1 < n_stream else None
        outs.append(run(*cur))
        cur = nxt
    sync()
    t_stream = time.perf_counter() - t0
    del outs
    t0 = time.perf_counter()
    for k in range(n_stream):
        cur = stage(k)
        sync()
        run(*cur)
        sync()
    t_serial = time.perf_counter() - t0
    tot_mb = n_stream * batch * N / 1e6
    return {
        "n_batches": n_stream,
        "h2d_mbps": round(tot_mb / t_transfer, 2),
        "wall_serial_mbps": round(tot_mb / t_serial, 2),
        "wall_stream_mbps": round(tot_mb / t_stream, 2),
        "overlap_saved_ms": round((t_serial - t_stream) * 1e3, 1),
        "overlapped": bool(t_stream < 0.97 * t_serial),
    }


def _check_window(out, window_b: bytes, host: HostEngine, rdict) -> bool:
    """One window's device ids, misses spliced as the host does them,
    against ``host.encode_ordinary``; an overflowed window is a
    mismatch (resident.py:790-821)."""
    if bool(out[5]):
        return False
    ids = out[0][: int(out[1])]
    if int(out[8]):
        sp_s, sp_l = out[6].tolist(), out[7].tolist()
        idl = ids.tolist()
        got: list[int] = []
        prev = 0
        for j, p in enumerate(np.nonzero(ids == SENTINEL)[0].tolist()):
            got.extend(idl[prev:p])
            piece = window_b[sp_s[j] : sp_s[j] + sp_l[j]]
            r = rdict.get(piece)
            if r is not None:
                got.append(r)
            else:
                got.extend(byte_pair_merge(piece, rdict))
            prev = p + 1
        got.extend(idl[prev:])
    else:
        got = ids.tolist()
    return got == host.encode_ordinary(window_b.decode("utf-8"))
