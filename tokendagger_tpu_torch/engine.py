"""Device tokenization engine: safe-cut windows over any UTF-8 text.

``DeviceEngine`` ordinary-encodes byte segments of any length through
fixed-shape windows (the stream path of the JAX package's
``engine.DeviceEngine``). Per window, on the device:

1. UTF-8 decode to codepoints: ``ops/pretokenize.utf8_decode`` (kernel K9,
   then K4 for the compaction);
2. char-level piece starts: ``ops/bitplane.piece_starts_chars`` (kernel
   K1, codepoint entry), mapped to byte flags by ``starts_to_bytes``;
3. piece keys: ``ops/compact.compact_piece_keys`` (kernel K2+K3);
4. whole-piece probe: ``ops/join.vocab_probe8`` (plain torch);
5. trim-aware finalize: ``ops/fused.finalize_host`` (kernel K4 twice).

One small device-to-host copy then reads the overflow flag, the id count,
the miss count and the consumed bytes; the ids and miss spans follow.

A window is cut at a *safe* offset (``_safe_cut_threshold``): pieces that
end before the start of the character-class run touching the window's end
(minus lookahead slack) cannot change with the bytes after it; the rest is
scanned again in the next window. Misses splice exactly on the host (a
whole-piece dict lookup, then ``byte_pair_merge``). Two exact host routes
remain, both counted in ``EngineStats``: a window whose pieces overflow
the slot capacity, and a class run longer than the largest window, take
``_host_advance``. The ids equal ``HostEngine.encode_ordinary``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import AbstractSet, Iterator

import numpy as np
import torch

from .convert import EngineTables, engine_tables_from_ranks
from .hostengine import HostEngine, byte_pair_merge
from .ops.bitplane import piece_starts_chars
from .ops.compact import compact_piece_keys
from .ops.fused import SENTINEL, caps_for, finalize_host
from .ops.join import vocab_probe8
from .ops.pretokenize import starts_to_bytes, utf8_decode
from .streaming import _safe_cut_chars, coarse_classes
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


@dataclass
class EngineStats:
    """Counters and a host-clock split of the engine's work."""

    windows: int = 0               # device windows run
    cut_windows: int = 0           # windows ended at a safe cut
    grown_windows: int = 0         # windows retried larger (no safe cut)
    host_advance_windows: int = 0  # overflow / over-long runs, host-encoded
    spliced_pieces: int = 0        # device misses merged on the host
    safe_cut_s: float = 0.0        # _safe_cut_threshold
    device_s: float = 0.0          # staging + pipeline + the scalar read
    drain_s: float = 0.0           # id copy-back + miss splice
    host_s: float = 0.0            # _host_advance


class DeviceEngine:
    """Windowed device encoder for the four supported pattern profiles.

    ``device`` holds the tables and runs the stages (CPU tensors run every
    kernel's plain version); ``tables`` are prebuilt ``EngineTables`` on
    it. Windows start at 4 MB on a card (growing to ``MAX_WINDOW``) and
    are 64 KB on the CPU."""

    def __init__(
        self,
        pattern: str,
        mergeable_ranks: dict[bytes, int],
        special_tokens: dict[str, int],
        *,
        device: str | torch.device = "cuda",
        tables: EngineTables | None = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        kind = classify_pattern(pattern)
        missing = [b for b in range(256)
                   if bytes([b]) not in mergeable_ranks]
        if kind is None or missing:
            why = ("the pattern is not one of the four supported profiles"
                   if kind is None else
                   f"the vocabulary lacks {len(missing)} single-byte ranks")
            raise NotImplementedError(
                f"DeviceEngine: {why}; the device piece path for such "
                "inputs is not ported yet (ROADMAP.md queue 1, item 13)")
        self._profile = kind
        self.host = HostEngine(pattern, mergeable_ranks, special_tokens)
        self.ranks = self.host.ranks
        if tables is None:
            tables = engine_tables_from_ranks(
                self.ranks, special_tokens, device=self.device)
        self.tables = tables
        cpu = self.device.type == "cpu"
        self._window = CPU_WINDOW if cpu else CARD_WINDOW
        self._max_window = CPU_WINDOW if cpu else MAX_WINDOW
        self.stats = EngineStats()

    # ==================================================================
    # Stream path (fixed-shape windowed scanning)
    # ==================================================================
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
                np.frombuffer(tail.encode("utf-32-le"), dtype=np.uint32))
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
        t = time.perf_counter()
        self.stats.host_advance_windows += 1
        n = len(data)
        wsize = max(self._max_window, 1 << 16) * 4
        while True:
            end = min(n, base + wsize)
            while end < n and (data[end] & 0xC0) == 0x80:
                end += 1  # align to a char boundary
            text = data[base:end].decode("utf-8", errors="strict")
            if end >= n:
                ids = self.host.encode_ordinary(text)
                self.stats.host_s += time.perf_counter() - t
                return np.asarray(ids, dtype=np.int64), n - base
            rs_c = _safe_cut_chars(text)
            last_end_c = 0
            if rs_c > 0:
                for _, e in self.host.split_spans(text):
                    if e > rs_c:
                        break
                    last_end_c = e
            if last_end_c == 0:
                wsize *= 4  # run still spans the host window: keep growing
                continue
            prefix = text[:last_end_c]
            ids = self.host.encode_ordinary(prefix)
            self.stats.host_s += time.perf_counter() - t
            return np.asarray(ids, dtype=np.int64), len(prefix.encode("utf-8"))

    def window_pipeline(self, data: torch.Tensor, nbytes: torch.Tensor,
                        trim: int):
        """The device stages on one staged window: (1, N) uint8 and (1,)
        int32 length on the engine's device. Returns ``finalize_host``'s
        9-tuple."""
        N = data.shape[1]
        p_cap = caps_for(N)["p_cap"]
        cp, cob, _boc, m = utf8_decode(data, nbytes)
        starts = piece_starts_chars(cp, m, profile=self._profile)
        stb = starts_to_bytes(starts, cob, data, nbytes)
        sb, pl, k0, k1, k2, k3, npc = compact_piece_keys(stb, data, nbytes,
                                                         p_cap)
        rank = vocab_probe8(k0, k1, k2, k3, pl, self.tables.vhash8_rows,
                            self.tables.vhash8_mask)
        return finalize_host(sb, pl, rank, npc, trim, p_cap=p_cap)

    def _fused_window(self, window: bytes, trim: int):
        """Run the device stages on one window. Returns (flat ids | None on
        capacity overflow, consumed_bytes)."""
        t = time.perf_counter()
        n = len(window)
        N = next(s for s in SCAN_SIZES if s >= n)
        buf = np.zeros((1, N), dtype=np.uint8)
        buf[0, :n] = np.frombuffer(window, dtype=np.uint8)
        data = torch.from_numpy(buf).to(self.device)
        nb = torch.tensor([n], dtype=torch.int32, device=self.device)
        (flat, total, _np, _nk, consumed, overflow, ms_s, ms_l,
         n_ms) = self.window_pipeline(data, nb, trim)
        # the one synchronizing read of the window's scalars
        ovf, total_i, n_ms_i, consumed_i = torch.stack(
            [overflow.to(torch.int32), total, n_ms, consumed],
            dim=1)[0].tolist()
        self.stats.windows += 1
        t2 = time.perf_counter()
        self.stats.device_s += t2 - t
        if ovf:
            return None, 0
        ids = flat[0, :total_i].cpu().numpy().astype(np.int64)
        if n_ms_i:
            self.stats.spliced_pieces += n_ms_i
            ids = self._splice_oversize(ids, window,
                                        ms_s[0, :n_ms_i].cpu().numpy(),
                                        ms_l[0, :n_ms_i].cpu().numpy(),
                                        n_ms_i)
        self.stats.drain_s += time.perf_counter() - t2
        return ids, consumed_i

    def _splice_oversize(self, ids: np.ndarray, window: bytes,
                         os_s: np.ndarray, os_l: np.ndarray,
                         n_os: int) -> np.ndarray:
        """Replace SENTINEL slots with the exact encoding of each missed
        piece (both are in piece order)."""
        sent_pos = np.nonzero(ids == SENTINEL)[0]
        if len(sent_pos) != n_os:
            raise RuntimeError(f"{len(sent_pos)} SENTINEL slots for "
                               f"{n_os} missed pieces")
        parts = []
        prev = 0
        for j, p in enumerate(sent_pos):
            parts.append(ids[prev:p])
            piece = window[int(os_s[j]) : int(os_s[j]) + int(os_l[j])]
            # whole-piece lookup FIRST, like the oracle (hostengine
            # encode_ordinary): a probe miss on device may be a deliberate
            # false miss (token dropped from the device hash table), and
            # merge(piece) == [rank] is a vocab property, not a guarantee
            r = self.ranks.get(piece)
            parts.append(np.asarray(
                [r] if r is not None else byte_pair_merge(piece, self.ranks),
                dtype=ids.dtype,
            ))
            prev = p + 1
        parts.append(ids[prev:])
        return np.concatenate(parts)

    def encode_stream(self, data: bytes) -> np.ndarray:
        """Ordinary-encode one byte segment through the windowed device
        pipeline. Arbitrary length; all device calls use fixed shapes."""
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
                t = time.perf_counter()
                trim = self._safe_cut_threshold(window)
                self.stats.safe_cut_s += time.perf_counter() - t
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
                    self.stats.grown_windows += 1
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
                self.stats.cut_windows += 1
            win = self._window
        if not out:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(out)

    def encode_streams(self, segments: list[bytes]) -> list[np.ndarray]:
        """Ordinary-encode each byte segment. Every segment takes
        ``encode_stream``; the JAX package's batched grid for many short
        segments (a batching choice with the same ids) is not ported."""
        return [self.encode_stream(s) if s else np.zeros(0, dtype=np.int64)
                for s in segments]

    # ==================================================================
    # Text-level encoding
    # ==================================================================
    def encode_ordinary_batch(self, texts: list[str]) -> list[list[int]]:
        flats = self.encode_streams([t.encode("utf-8") for t in texts])
        return [f.tolist() for f in flats]

    def encode_batch(
        self, texts: list[str], allowed_special: AbstractSet[str]
    ) -> list[list[int]]:
        """Full encode semantics: special-token scan on the host, each
        ordinary segment through the device stream path."""
        return self._encode_batch_stream(texts, allowed_special)

    def _encode_batch_stream(
        self, texts: list[str], allowed_special: AbstractSet[str]
    ) -> list[list[int]]:
        segments: list[bytes] = []
        plans: list[list[tuple[str, int]]] = []
        for text in texts:
            plan: list[tuple[str, int]] = []
            for seg_text, special_id in self._split_specials(text,
                                                             allowed_special):
                if special_id is not None:
                    plan.append(("sp", special_id))
                else:
                    plan.append(("seg", len(segments)))
                    segments.append(seg_text.encode("utf-8"))
            plans.append(plan)
        flats = self.encode_streams(segments)
        out = []
        for plan in plans:
            ids: list[int] = []
            for kind, payload in plan:
                if kind == "sp":
                    ids.append(payload)
                else:
                    ids.extend(flats[payload].tolist())
            out.append(ids)
        return out

    def _split_specials(
        self, text: str, allowed: AbstractSet[str]
    ) -> Iterator[tuple[str, int | None]]:
        return self.host.split_specials(text, allowed)
