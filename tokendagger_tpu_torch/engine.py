"""Device tokenization engine: safe-cut windows over any UTF-8 text, and
the piece path for any tokenizer.

``DeviceEngine`` serves every tokenizer, as the JAX package's
``engine.DeviceEngine`` does. With a pattern of one of the five profiles
and a rank for every single byte it takes the *stream path*
(``stream=True``, the default then); otherwise the *piece path*.

Stream path: byte segments of any length go through fixed-shape windows.
Per window, on the device:

1. UTF-8 decode to codepoints: ``ops/pretokenize.utf8_decode`` (kernel K9,
   then K4 for the compaction);
2. char-level piece starts: ``ops/bitplane.piece_starts_chars`` (kernel
   K1, codepoint entry), mapped to byte flags by ``starts_to_bytes``;
3. piece keys: ``ops/compact.compact_piece_keys`` (kernel K2+K3);
4. whole-piece probe: ``ops/join.vocab_probe8`` (the probe kernel);
5. trim-aware finalize: ``ops/fused.finalize_host`` (kernel K4 twice).

One small device-to-host copy then reads the overflow flag, the id count,
the miss count and the consumed bytes; the ids and miss spans follow.
With ``miss_mode="device"`` or ``join_mode="sort"`` stages 3-5 are
``ops/fused.resolve_window`` instead: the whole-piece lookup is the probe
or the sort join (``ops/join.vocab_join``), and under "device" the misses
of at most 256 bytes are BPE-merged on the card (``ops/merge.merge_rows``)
so that only longer pieces reach the host.

Piece path: the host splits the text (``HostEngine.split_spans``); each
unique piece takes its whole-piece rank if it has one, a piece over 256
bytes or with a byte without a rank takes ``byte_pair_merge`` on the
host, and the rest are packed into rows of width 16, 64 or 256 and merged
on the device (``merge_rows``), ``MERGE_ROWS`` rows a launch.

``encode_streams`` packs four or more short complete segments (at most
4,096 B) into (rows, width) grids, resolved many per launch by
``ops/batched.resolve_grid`` with the same stages; the rest take the
window path. Both give the same ids, so routing is a batching choice.

Several threads may encode through one engine (``corpus.CorpusProcessor``
runs a thread pool): one lock holds each window's, each grid's and each
merge batch's device section (staging, the stage launches and the reads
back) to one thread at a time, and every update of ``stats`` goes through
``_tally`` under it. The merge tables are built under it too, at the
first call that needs them, so that a stream engine's construction costs
nothing more.
Miss splicing and the other host work run outside it.

``EngineStats`` counts the work and times its sections on the host clock.
While a ``torch.profiler`` trace records, the same sections and each
window's stages are ``td.*`` ranges on the trace's clock
(``utils/profiling.span``): ``td.window`` with ``td.window.stage``, one
range a stage and ``td.window.read``; ``td.drain`` with ``td.copyback`` and
``td.splice``; ``td.safe_cut``, ``td.grid``, ``td.merge``,
``td.host_advance``, ``td.specials``, ``td.utf8`` and ``td.lists``.

Segments that each fit one window (the spans between a document's
special tokens) share launches: two or more of one call run as a (B, N)
batch of windows (``_encode_windows_batched``), so that K1's ~165 passes,
which cost a window the same whatever it holds, are paid once a batch.

A window is cut at a *safe* offset (``_safe_cut_threshold``): pieces that
end before the start of the character-class run touching the window's end
(minus lookahead slack) cannot change with the bytes after it; the rest is
scanned again in the next window. Misses splice exactly on the host, a
window's or a grid row's in one native call (``native.NativeSplicer``:
the whole-piece hash, the thread's memo, then the exact merge; from
1,024 misses on, on up to 8 threads), or without a C++ toolchain in
Python (a whole-piece dict lookup, then ``byte_pair_merge``). Two exact
host routes remain, both counted in ``EngineStats``: a window whose
pieces overflow the slot capacity, and a class run longer than the
largest window, take ``_host_advance``. The ids equal
``HostEngine.encode_ordinary``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import AbstractSet, Iterator

import numpy as np
import torch

from . import native
from .convert import (
    EngineTables, MergeTables, engine_tables_from_ranks,
    merge_tables_from_ranks,
)
from .hostengine import HostEngine, byte_pair_merge
from .ops.batched import ROW_WIDTHS, grid_rows, resolve_grid
from .ops.bitplane import piece_starts_chars
from .ops.compact import compact_piece_keys
from .ops.fused import SENTINEL, caps_for, finalize_host, resolve_window
from .ops.join import vocab_probe8
from .ops.merge import merge_rows
from .ops.pretokenize import starts_to_bytes, utf8_decode
from .streaming import _safe_cut_chars, coarse_classes
from .tables import all_reachable
from .unicode_tables import han_plane
from .utils.profiling import span
from .vocab import classify_pattern

# Window shapes: every device call uses one of these lengths.
SCAN_SIZES = (1 << 12, 1 << 16, 1 << 20, 1 << 22, 1 << 24)
# windows grow up to this size when a single class run spans the current
# window (no safe cut); only beyond it does the host route engage
MAX_WINDOW = SCAN_SIZES[-1]

# Lookahead slack past a run boundary that a match decision can inspect
# (contraction suffix <= 3 chars + the (?!\S) peek; chars <= 4 bytes).
CUT_SLACK = 16

# Card window: 4 MB, growing to MAX_WINDOW. On the CPU (the tests) 64 KB
# for both, so that windows cut where the JAX package's CPU engine cuts.
CARD_WINDOW = SCAN_SIZES[3]
CPU_WINDOW = SCAN_SIZES[1]

# Complete segments of one call share the window stages: at most this
# many windows a batch, and at most BATCH_BYTES of (padded) shape.
BATCH_WINDOWS = 8
BATCH_BYTES = 1 << 23

# Piece path: row widths of the merge batches (a longer piece merges on
# the host) and the most rows of one merge launch. Batches are not padded
# to a power of two: that padding served XLA's compile cache.
BUCKET_WIDTHS = (16, 64, 256)
MERGE_ROWS = 1 << 13


@dataclass
class EngineStats:
    """Counters and a host-clock split of the engine's work."""

    windows: int = 0               # device windows run
    # of those, run by _encode_windows_batched, and its batches
    batched_windows: int = 0
    window_batches: int = 0
    cut_windows: int = 0           # windows ended at a safe cut
    grown_windows: int = 0         # windows retried larger (no safe cut)
    host_advance_windows: int = 0  # overflow / over-long runs, host-encoded
    spliced_pieces: int = 0        # device misses spliced on the host
    # of those, whole tokens (the rest were merged): pieces over the
    # probe's 16-byte keys, and tokens its table dropped
    spliced_whole: int = 0
    # of those, spliced by the native route (td_splice), the rest in Python
    spliced_native: int = 0
    # of those, pieces whose first code point is Han (both routes): under
    # kimi a Han run over 16 bytes, which the probe's keys cannot hold
    spliced_han: int = 0
    grid_rows: int = 0             # short segments resolved in grids
    # (rows, width) grids run, by width
    grids_by_width: dict[int, int] = field(default_factory=dict)
    safe_cut_s: float = 0.0        # _safe_cut_threshold
    device_s: float = 0.0          # staging + pipeline + the scalar read
    drain_s: float = 0.0           # id copy-back + miss splice
    host_s: float = 0.0            # _host_advance
    grid_s: float = 0.0            # staging + grid stages + reads + splice
    # device merge rows by width (piece path, miss_mode="device" windows)
    merge_rows_by_width: dict[int, int] = field(default_factory=dict)
    # piece path: unique pieces by route, and the merge batches' time
    piece_hits: int = 0            # whole-piece ranks
    piece_host_merges: int = 0     # > 256 bytes or a byte without a rank
    merge_s: float = 0.0           # staging + merge launches + reads

    @property
    def grids(self) -> int:
        return sum(self.grids_by_width.values())


class DeviceEngine:
    """Device encoder for any tokenizer (see the module doc).

    ``device`` holds the tables and runs the stages (CPU tensors run every
    kernel's plain version); ``tables`` are prebuilt ``EngineTables`` on
    it. ``stream`` picks the path; None takes the stream path when the
    pattern is one of the five profiles and every single byte has a rank
    (the JAX package's rule). ``vocab_fastpath=False`` sends every
    multi-byte piece of the piece path through the device merge, whole
    vocab tokens included; their ids still come from the whole-piece rank,
    as the host engine's do. The attributes ``miss_mode`` ("host" or
    "device") and ``join_mode`` ("probe" or "sort") choose the stream
    path's window stages. Windows start at 4 MB on a card (growing to
    ``MAX_WINDOW``) and are 64 KB on the CPU."""

    def __init__(
        self,
        pattern: str,
        mergeable_ranks: dict[bytes, int],
        special_tokens: dict[str, int],
        *,
        device: str | torch.device = "cuda",
        tables: EngineTables | None = None,
        stream: bool | None = None,
        vocab_fastpath: bool = True,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self._profile = classify_pattern(pattern)
        self.host = HostEngine(pattern, mergeable_ranks, special_tokens)
        self.ranks = self.host.ranks
        self._byte_rank = np.asarray(
            [self.ranks.get(bytes([b]), -1) for b in range(256)], np.int32)
        self._missing_bytes = bool((self._byte_rank < 0).any())
        if stream is None:
            stream = self._profile is not None and not self._missing_bytes
        if stream and self._profile is None:
            raise ValueError("the stream path needs a pattern of one of the "
                             "five profiles; use stream=False")
        self.stream = bool(stream)
        self.vocab_fastpath = vocab_fastpath
        self.miss_mode = "host"
        self.join_mode = "probe"
        self._merge: MergeTables | None = None
        self._all_reachable: bool | None = None
        if tables is None:
            tables = engine_tables_from_ranks(
                self.ranks, special_tokens, device=self.device)
        self.tables = tables
        self._splicer = None  # the native splice's table: stream path only
        if self.stream:
            try:
                self._splicer = native.NativeSplicer(self.ranks,
                                                     self._byte_rank)
            except RuntimeError:  # no toolchain, or a vocabulary it refuses
                pass
        cpu = self.device.type == "cpu"
        self._window = CPU_WINDOW if cpu else CARD_WINDOW
        self._max_window = CPU_WINDOW if cpu else MAX_WINDOW
        self.stats = EngineStats()
        self._lock = threading.RLock()

    def _tally(self, **deltas) -> None:
        """Add ``deltas`` to the fields of ``stats``, under the lock; a
        dict delta adds key by key (``grids_by_width``)."""
        with self._lock:
            for k, v in deltas.items():
                if isinstance(v, dict):
                    d = getattr(self.stats, k)
                    for kk, vv in v.items():
                        d[kk] = d.get(kk, 0) + vv
                else:
                    setattr(self.stats, k, getattr(self.stats, k) + v)

    def merge_tables(self) -> MergeTables:
        """The device merge's tables, built on first use under the lock."""
        with self._lock:
            if self._merge is None:
                self._merge = merge_tables_from_ranks(self.ranks,
                                                      device=self.device)
            return self._merge

    def all_reachable(self) -> bool:
        """The vocabulary's merge-reachability audit
        (``tables.all_reachable``), run at the first call under the lock
        and kept: seconds for a 200,000-token vocabulary, which engine
        construction does not pay."""
        with self._lock:
            if self._all_reachable is None:
                self._all_reachable = all_reachable(self.ranks)
            return self._all_reachable

    # ==================================================================
    # Stream path (fixed-shape windowed scanning)
    # ==================================================================
    def _need_stream(self) -> None:
        if not self.stream:
            raise ValueError("this engine takes the piece path (stream="
                             "False): encode texts with encode_batch or "
                             "encode_ordinary_batch")

    def _safe_cut_threshold(self, window: bytes) -> int:
        """Largest byte offset rs such that every piece ending <= rs is
        unaffected by bytes beyond the window: rs = start of the
        character-class run touching the window edge, minus lookahead
        slack.

        The run start must be found exactly: if the decoded tail is one
        unbroken class run, the run may begin before the tail, so the
        backward search extends until a class change is found (or the
        window start is reached, in which case there is no safe cut)."""
        tail_n = 8192
        while True:
            t0 = max(0, len(window) - tail_n)
            at_start = t0 == 0
            # align to a char boundary
            while t0 < len(window) and (window[t0] & 0xC0) == 0x80:
                t0 += 1
            tail = window[t0:].decode("utf-8", errors="ignore")
            if not tail:
                if at_start:
                    return 0
                tail_n *= 4
                continue
            co = coarse_classes(
                np.frombuffer(tail.encode("utf-32-le"), dtype=np.uint32),
                han=self._profile == "kimi")
            # last index where the class differs -> run start is one past it
            diff = np.nonzero(co != co[-1])[0]
            if len(diff) == 0:
                if at_start:
                    return 0  # whole window is one run: no safe cut
                tail_n *= 4  # run may start before the tail: look further back
                continue
            run_start_char = int(diff[-1]) + 1
            # byte offset of run_start_char within the tail
            run_start_b = t0 + len(tail[:run_start_char].encode("utf-8"))
            return max(0, run_start_b - CUT_SLACK)

    def _host_advance(self, data: bytes, base: int) -> tuple[np.ndarray, int]:
        """Exact host route when a window overflows or a single class run
        outgrows the largest device window: host-encode the maximal
        *finalized* prefix (pieces ending at or before a safe cut found in
        a geometrically grown host window) and return (ids,
        consumed_bytes) so the caller resumes the device path right after
        it."""
        with span("td.host_advance"):
            t = time.perf_counter()
            self._tally(host_advance_windows=1)
            n = len(data)
            wsize = max(self._max_window, 1 << 16) * 4
            while True:
                end = min(n, base + wsize)
                while end < n and (data[end] & 0xC0) == 0x80:
                    end += 1  # align to a char boundary
                text = data[base:end].decode("utf-8", errors="strict")
                if end >= n:
                    ids = self.host.encode_ordinary(text)
                    self._tally(host_s=time.perf_counter() - t)
                    return np.asarray(ids, dtype=np.int64), n - base
                rs_c = _safe_cut_chars(text, han=self._profile == "kimi")
                last_end_c = 0
                if rs_c > 0:
                    for _, e in self.host.split_spans(text):
                        if e > rs_c:
                            break
                        last_end_c = e
                if last_end_c == 0:
                    wsize *= 4  # run still spans the host window: grow
                    continue
                prefix = text[:last_end_c]
                ids = self.host.encode_ordinary(prefix)
                self._tally(host_s=time.perf_counter() - t)
                return (np.asarray(ids, dtype=np.int64),
                        len(prefix.encode("utf-8")))

    def window_pipeline(self, data: torch.Tensor, nbytes: torch.Tensor,
                        trim: int, rows_out: dict | None = None):
        """The device stages on one staged window: (1, N) uint8 and (1,)
        int32 length on the engine's device. Returns ``finalize_host``'s
        9-tuple, or ``resolve_window``'s under a non-default ``miss_mode``
        or ``join_mode`` (which fills ``rows_out`` with its merge rows by
        width)."""
        N = data.shape[1]
        p_cap = caps_for(N)["p_cap"]
        resolve = self.miss_mode != "host" or self.join_mode != "probe"
        if resolve and self.miss_mode == "device" and self._missing_bytes:
            raise ValueError("miss_mode='device' needs a rank for every "
                             "single byte")
        with span("td.window.decode"):
            cp, cob, boc, m = utf8_decode(data, nbytes)
        with span("td.window.starts"):
            starts = piece_starts_chars(cp, m, profile=self._profile)
            if not resolve:
                stb = starts_to_bytes(starts, cob, data, nbytes)
        if resolve:
            mt = self.merge_tables()
            with span("td.window.resolve"):
                return resolve_window(
                    starts, boc, data, nbytes, trim, mt.byte_rank,
                    mt.pair_rows, mt.pair_lut, mt.vk, mt.vlen, mt.vrank,
                    self.tables.vhash8_rows, mask=mt.pair_mask,
                    vhash_mask=self.tables.vhash8_mask,
                    join_mode=self.join_mode, miss_mode=self.miss_mode,
                    rows_out=rows_out, **caps_for(N))
        with span("td.window.compact"):
            sb, pl, k0, k1, k2, k3, npc = compact_piece_keys(stb, data,
                                                             nbytes, p_cap)
        with span("td.window.probe"):
            rank = vocab_probe8(k0, k1, k2, k3, pl, self.tables.vhash8_rows,
                                self.tables.vhash8_mask)
        with span("td.window.finalize"):
            return finalize_host(sb, pl, rank, npc, trim, p_cap=p_cap)

    def _fused_window(self, window: bytes, trim: int):
        """Run the device stages on one window. Returns (flat ids | None on
        capacity overflow, consumed_bytes)."""
        # td.drain opens under the lock (the copy-back) and closes after the
        # splice, which runs outside it; closing a span never opened does
        # nothing
        drain = span("td.drain")
        try:
            with self._lock:
                with span("td.window"):
                    t = time.perf_counter()
                    with span("td.window.stage"):
                        n = len(window)
                        N = next(s for s in SCAN_SIZES if s >= n)
                        buf = np.zeros((1, N), dtype=np.uint8)
                        buf[0, :n] = np.frombuffer(window, dtype=np.uint8)
                        data = torch.from_numpy(buf).to(self.device)
                        nb = torch.tensor([n], dtype=torch.int32,
                                          device=self.device)
                    rows: dict = {}
                    (flat, total, _np, _nk, consumed, overflow, ms_s, ms_l,
                     n_ms) = self.window_pipeline(data, nb, trim, rows)
                    with span("td.window.read"):
                        # the one synchronizing read of the window's scalars
                        ovf, total_i, n_ms_i, consumed_i, *n_rows = (
                            torch.stack(
                                [overflow.to(torch.int32), total, n_ms,
                                 consumed]
                                + [rows[w].to(torch.int32)
                                   for w in sorted(rows)],
                                dim=1)[0].tolist())
                    t2 = time.perf_counter()
                if ovf:
                    self._tally(windows=1, device_s=t2 - t)
                    return None, 0
                drain.__enter__()
                with span("td.copyback"):
                    ids = flat[0, :total_i].cpu().numpy().astype(np.int64)
                    os_s = ms_s[0, :n_ms_i].cpu().numpy()
                    os_l = ms_l[0, :n_ms_i].cpu().numpy()
            if n_ms_i:
                with span("td.splice"):
                    ids = self._splice_oversize(ids, window, os_s, os_l,
                                                n_ms_i)
            self._tally(windows=1, device_s=t2 - t,
                        drain_s=time.perf_counter() - t2,
                        merge_rows_by_width=dict(zip(sorted(rows), n_rows)))
        finally:
            drain.__exit__(None, None, None)
        return ids, consumed_i

    def _splice_oversize(self, ids: np.ndarray, window: bytes,
                         os_s: np.ndarray, os_l: np.ndarray,
                         n_os: int) -> np.ndarray:
        """Replace SENTINEL slots with the exact encoding of each missed
        piece (both are in piece order), and count the pieces in
        ``stats``. One native call (``td_splice``) where the engine has
        its table; else, or where that call meets a byte without a rank,
        the Python loop below. Both resolve a piece alike."""
        splicer = self._splicer
        if splicer is not None:
            got = splicer.splice(ids, window, os_s, os_l, n_os, SENTINEL)
            if got is not None:
                out, whole, han = got
                self._tally(spliced_pieces=n_os, spliced_whole=whole,
                            spliced_native=n_os, spliced_han=han)
                return out
            self._splicer = None
        sent_pos = np.nonzero(ids == SENTINEL)[0]
        if len(sent_pos) != n_os:
            raise RuntimeError(f"{len(sent_pos)} SENTINEL slots for "
                               f"{n_os} missed pieces")
        parts = []
        prev = 0
        whole = han = 0
        is_han = han_plane()
        for j, p in enumerate(sent_pos):
            parts.append(ids[prev:p])
            piece = window[int(os_s[j]) : int(os_s[j]) + int(os_l[j])]
            first = piece[:4].decode("utf-8", "ignore")[:1]
            if first and is_han[ord(first)]:
                han += 1
            # whole-piece lookup FIRST, like the oracle (hostengine
            # encode_ordinary): a probe miss on device may be a deliberate
            # false miss (token dropped from the device hash table), and
            # merge(piece) == [rank] is a vocab property, not a guarantee
            r = self.ranks.get(piece)
            if r is not None:
                whole += 1
            parts.append(np.asarray(
                [r] if r is not None else byte_pair_merge(piece, self.ranks),
                dtype=ids.dtype,
            ))
            prev = p + 1
        parts.append(ids[prev:])
        self._tally(spliced_pieces=n_os, spliced_whole=whole,
                    spliced_han=han)
        return np.concatenate(parts)

    def encode_stream(self, data: bytes) -> np.ndarray:
        """Ordinary-encode one byte segment through the windowed device
        pipeline. Arbitrary length; all device calls use fixed shapes."""
        self._need_stream()
        out: list[np.ndarray] = []
        base = 0
        n = len(data)
        win = self._window
        while base < n:
            window = data[base : base + win]
            is_final = base + len(window) >= n
            if is_final:
                trim = len(window)
            else:
                with span("td.safe_cut"):
                    t = time.perf_counter()
                    trim = self._safe_cut_threshold(window)
                    self._tally(safe_cut_s=time.perf_counter() - t)
            result = (None, 0)
            if trim > 0:
                result = self._fused_window(window, trim)
                if result[0] is None:
                    # capacity overflow (pathological piece mix): exact
                    # host route for a bounded prefix, then resume
                    ids, adv = self._host_advance(data, base)
                    out.append(ids)
                    base += adv
                    win = self._window
                    continue
            ids, consumed = result
            if consumed == 0:
                # no piece is final inside this window (a single class run
                # spans it). Grow the window (fixed shapes, up to the cap)...
                if win < self._max_window and win < n - base:
                    win = min(win * 4, self._max_window)
                    self._tally(grown_windows=1)
                    continue
                # ...then runs longer than the cap take the exact host
                # route, but only past the run — the device path resumes.
                ids, adv = self._host_advance(data, base)
                out.append(ids)
                base += adv
                win = self._window
                continue
            out.append(ids)
            base += consumed
            if not is_final:
                self._tally(cut_windows=1)
            win = self._window
        if not out:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(out)

    def encode_streams(self, segments: list[bytes]) -> list[np.ndarray]:
        """Ordinary-encode each byte segment. With four or more non-empty
        segments of at most ``ROW_WIDTHS[-1]`` bytes, those go through
        (rows, width) grids (``_encode_small_batched``); two or more of
        the rest that each fit one window share batched windows
        (``_encode_windows_batched``); every other segment, and a batched
        one whose window overflowed, takes ``encode_stream``."""
        self._need_stream()
        out: list[np.ndarray | None] = [None] * len(segments)
        small: list[tuple[int, bytes]] = []
        for i, s in enumerate(segments):
            if not s:
                out[i] = np.zeros(0, dtype=np.int64)
            elif len(s) <= ROW_WIDTHS[-1]:
                small.append((i, s))
        if len(small) >= 4:  # grids pay off only with several rows
            self._encode_small_batched(small, out)
        whole = [(i, s) for i, s in enumerate(segments)
                 if out[i] is None and len(s) <= self._window]
        if (len(whole) >= 2 and self.miss_mode == "host"
                and self.join_mode == "probe"):
            self._encode_windows_batched(whole, out)
        for i, s in enumerate(segments):
            if out[i] is None:
                out[i] = self.encode_stream(s)
        return out  # type: ignore[return-value]

    def _encode_windows_batched(self, items: list[tuple[int, bytes]],
                                out: list[np.ndarray | None]) -> None:
        """Resolve (index, segment) pairs, each segment complete in one
        window, as (B, N) batches of windows: the longest first, N the
        smallest of ``SCAN_SIZES`` that holds a batch's longest, at most
        ``BATCH_WINDOWS`` windows and ``BATCH_BYTES`` of shape a batch.
        A batch runs the window stages once, K1's codepoint entry on B
        windows in one launch, so a call's card time follows its bytes
        and not the count of its segments. Each window's trim is its
        length (every piece is final). A window that overflowed its piece
        slots is left in ``out`` as None for ``encode_stream``."""
        items = sorted(items, key=lambda it: -len(it[1]))
        lo = 0
        while lo < len(items):
            N = next(s for s in SCAN_SIZES if s >= len(items[lo][1]))
            batch = items[lo : lo + max(1, min(BATCH_WINDOWS,
                                               BATCH_BYTES // N))]
            lo += len(batch)
            B = len(batch)
            drain = span("td.drain")
            try:
                with self._lock:
                    with span("td.window"):
                        t = time.perf_counter()
                        with span("td.window.stage"):
                            # copy each window's bytes, not its padding
                            data = torch.zeros((B, N), dtype=torch.uint8,
                                               device=self.device)
                            for r, (_, s) in enumerate(batch):
                                data[r, : len(s)] = torch.frombuffer(
                                    bytearray(s), dtype=torch.uint8)
                            lens = np.asarray([len(s) for _, s in batch],
                                              dtype=np.int32)
                            nb = torch.from_numpy(lens).to(self.device)
                        (flat, total, _np, _nk, consumed, overflow, ms_s,
                         ms_l, n_ms) = self.window_pipeline(data, nb, nb)
                        with span("td.window.read"):
                            # the one synchronizing read of the scalars
                            ovf, total_r, n_ms_r, consumed_r = (
                                torch.stack([overflow.to(torch.int32), total,
                                             n_ms, consumed]).cpu().numpy())
                        t2 = time.perf_counter()
                    ok = (ovf == 0) & (consumed_r == lens)
                    drain.__enter__()
                    with span("td.copyback"):
                        k = int(total_r[ok].max()) if ok.any() else 0
                        flat_np = flat[:, :k].cpu().numpy()
                        kms = int(n_ms_r[ok].max()) if ok.any() else 0
                        if kms:
                            ms_np = torch.stack(
                                [ms_s[:, :kms], ms_l[:, :kms]]).cpu().numpy()
                for r, (i, s) in enumerate(batch):
                    if not ok[r]:
                        continue
                    ids = flat_np[r, : total_r[r]].astype(np.int64)
                    if n_ms_r[r]:
                        with span("td.splice"):
                            ids = self._splice_oversize(
                                ids, s, ms_np[0, r], ms_np[1, r],
                                int(n_ms_r[r]))
                    out[i] = ids
                self._tally(windows=B, batched_windows=B, window_batches=1,
                            device_s=t2 - t,
                            drain_s=time.perf_counter() - t2)
            finally:
                drain.__exit__(None, None, None)

    def _encode_small_batched(self, items: list[tuple[int, bytes]],
                              out: list[np.ndarray | None]) -> None:
        """Resolve (index, segment) pairs through grids bucketed by width
        (the smallest of ``ROW_WIDTHS`` that holds the segment), at most
        ``grid_rows(width)`` rows a grid, each row 0-padded; the ids land
        in ``out`` at each segment's index."""
        by_width: dict[int, list[tuple[int, bytes]]] = {
            w: [] for w in ROW_WIDTHS}
        for i, s in items:
            by_width[next(w for w in ROW_WIDTHS if len(s) <= w)].append(
                (i, s))
        for w, group in by_width.items():
            rows = grid_rows(w)
            for lo in range(0, len(group), rows):
                batch = group[lo : lo + rows]
                buf = np.zeros((len(batch), w), dtype=np.uint8)
                lens = np.zeros(len(batch), dtype=np.int32)
                for r, (_, s) in enumerate(batch):
                    buf[r, : len(s)] = np.frombuffer(s, dtype=np.uint8)
                    lens[r] = len(s)
                with span("td.grid"):
                    with self._lock:
                        t = time.perf_counter()
                        flat, total, ms_s, ms_l, n_ms = resolve_grid(
                            buf, lens, vhash_rows=self.tables.vhash8_rows,
                            vhash_mask=self.tables.vhash8_mask,
                            profile=self._profile)
                    for r, (i, s) in enumerate(batch):
                        ids = flat[r, : total[r]].astype(np.int64)
                        k = int(n_ms[r])
                        if k:
                            ids = self._splice_oversize(ids, s, ms_s[r],
                                                        ms_l[r], k)
                        out[i] = ids
                    self._tally(grid_rows=len(batch), grids_by_width={w: 1},
                                grid_s=time.perf_counter() - t)

    # ==================================================================
    # Piece path (host split, device merge; exact for any tokenizer)
    # ==================================================================
    def encode_pieces(self, pieces: list[bytes]) -> list[list[int]]:
        """Encode pretoken byte strings exactly (the JAX
        ``encode_pieces``): an empty piece gives [], a single byte (and,
        with ``vocab_fastpath``, a whole vocab token) its rank; every
        other piece is encoded once per unique value by
        ``_merge_unique``."""
        results: list[list[int] | None] = [None] * len(pieces)
        todo: dict[bytes, list[int]] = {}  # piece -> its indices
        for i, piece in enumerate(pieces):
            if not piece:
                results[i] = []
                continue
            if self.vocab_fastpath or len(piece) == 1:
                r = self.ranks.get(piece)
                if r is not None:
                    results[i] = [r]
                    continue
            todo.setdefault(piece, []).append(i)
        unique = list(todo)
        for piece, ids in zip(unique, self._merge_unique(unique)):
            for i in todo[piece]:
                results[i] = ids
        return results  # type: ignore[return-value]

    def _merge_unique(self, pieces: list[bytes]) -> list[list[int]]:
        """Ids of distinct pieces. A vocab token takes its rank first, as
        the host engine's lookup does (also a token the merge would not
        reach); a piece over 256 bytes, or holding a byte without a rank,
        merges on the host; the rest merge on the device in rows of the
        smallest of ``BUCKET_WIDTHS`` that holds them. Without
        ``vocab_fastpath`` the vocab tokens merge on the device too, and
        keep their rank."""
        out: list[list[int] | None] = [None] * len(pieces)
        by_width: dict[int, list[int]] = {w: [] for w in BUCKET_WIDTHS}
        rankless = bytes(np.flatnonzero(self._byte_rank < 0).tolist())
        n_hits = n_host = 0
        for i, piece in enumerate(pieces):
            r = self.ranks.get(piece)
            mergeable = len(piece) <= BUCKET_WIDTHS[-1] and (
                not rankless or len(piece.translate(None, rankless))
                == len(piece))
            if r is not None:
                out[i] = [r]
                n_hits += 1
            elif not mergeable:
                out[i] = byte_pair_merge(piece, self.ranks)
                n_host += 1
            if mergeable and (r is None or not self.vocab_fastpath):
                w = next(w for w in BUCKET_WIDTHS if len(piece) <= w)
                by_width[w].append(i)
        self._tally(piece_hits=n_hits, piece_host_merges=n_host)
        for w, idxs in by_width.items():
            for lo in range(0, len(idxs), MERGE_ROWS):
                chunk = idxs[lo : lo + MERGE_ROWS]
                buf = np.zeros((len(chunk), w), dtype=np.uint8)
                lens = np.zeros(len(chunk), dtype=np.int32)
                for row, i in enumerate(chunk):
                    p = pieces[i]
                    buf[row, : len(p)] = np.frombuffer(p, dtype=np.uint8)
                    lens[row] = len(p)
                mt = self.merge_tables()
                with self._lock, span("td.merge"):
                    t = time.perf_counter()
                    tok, _ = merge_rows(
                        torch.from_numpy(buf).to(self.device),
                        torch.from_numpy(lens).to(self.device),
                        mt.byte_rank, mt.pair_rows, mt.pair_mask)
                    tok = tok.cpu().numpy()
                    self._tally(merge_rows_by_width={w: len(chunk)},
                                merge_s=time.perf_counter() - t)
                for row, i in enumerate(chunk):
                    if out[i] is None:
                        ids = tok[row]
                        out[i] = ids[ids >= 0].tolist()
        return out  # type: ignore[return-value]

    # ==================================================================
    # Text-level encoding
    # ==================================================================
    def _encode_segments(self, segments: list[str]) -> list[list[int]]:
        """Ordinary-encode texts: the stream path, or on the piece path
        every text's pieces in one ``encode_pieces`` call."""
        if self.stream:
            with span("td.utf8"):
                datas = [s.encode("utf-8") for s in segments]
            flats = self.encode_streams(datas)
            with span("td.lists"):
                return [f.tolist() for f in flats]
        pieces: list[bytes] = []
        bounds = []
        for s in segments:
            lo = len(pieces)
            pieces.extend(s[a:b].encode("utf-8")
                          for a, b in self.host.split_spans(s))
            bounds.append((lo, len(pieces)))
        encoded = self.encode_pieces(pieces)
        with span("td.lists"):
            return [[i for ids in encoded[lo:hi] for i in ids]
                    for lo, hi in bounds]

    def encode_ordinary_batch(self, texts: list[str]) -> list[list[int]]:
        return self._encode_segments(list(texts))

    def encode_batch(
        self, texts: list[str], allowed_special: AbstractSet[str]
    ) -> list[list[int]]:
        """Full encode semantics: special-token scan on the host, every
        text's ordinary segments encoded together on the device."""
        segments: list[str] = []
        plans: list[list[tuple[str, int]]] = []
        with span("td.specials"):  # the split is lazy: consume it inside
            for text in texts:
                plan: list[tuple[str, int]] = []
                for seg_text, special_id in self._split_specials(
                        text, allowed_special):
                    if special_id is not None:
                        plan.append(("sp", special_id))
                    else:
                        plan.append(("seg", len(segments)))
                        segments.append(seg_text)
                plans.append(plan)
        encoded = self._encode_segments(segments)
        with span("td.lists"):
            out = []
            for plan in plans:
                ids: list[int] = []
                for kind, payload in plan:
                    if kind == "sp":
                        ids.append(payload)
                    else:
                        ids.extend(encoded[payload])
                out.append(ids)
        return out

    def _split_specials(
        self, text: str, allowed: AbstractSet[str]
    ) -> Iterator[tuple[str, int | None]]:
        return self.host.split_specials(text, allowed)
