"""Corpus encoder over the four-stage window pipeline, with double-buffered
staging.

``ResidentStream`` encodes a corpus in fixed-shape batches of char-aligned
windows (1 MB x 8 by default). Per batch, on the device:

1. piece starts: ``ops/bitplane.piece_starts_bits`` (kernel K1);
2. compaction: ``ops/compact.compact_piece_keys`` (kernel K2+K3) gives each
   piece's start, length and 16-byte key words;
3. whole-piece probe: ``ops/join.vocab_probe8`` against the ``vhash8``
   table (the probe kernel, ``csrc/probe.cu``);
4. finalize: ``ops/compact.finalize`` writes flat ids with SENTINEL for each
   miss and compacts the miss spans (kernel K4).

The host then splices each miss exactly (``splice.Splicer``, built at
construction: a whole-piece lookup first, then the merge). Non-ASCII
windows and capacity overflows take the exact host engine; both are
counted in ``StreamStats.host_fallback_windows``.
The ids of every window equal ``HostEngine.encode_ordinary`` of that window.

Staging on the card: each batch is written into one of two pinned host
buffers and copied to the device on a side stream with ``non_blocking``
copies; batch k+1's copy is issued before batch k's pipeline, so the copy
of one batch overlaps the compute of the one before it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .convert import StreamTables, tables_from_ranks
from .hostengine import HostEngine
from .ops.bitplane import piece_starts_bits
from .ops.compact import compact_piece_keys, finalize
from .ops.fused import caps_for
from .ops.join import vocab_probe8
from .splice import Splicer
from .utils.windows import stream_windows
from .vocab import refuse_kimi


@dataclass
class StreamStats:
    n_windows: int = 0
    n_batches: int = 0
    host_fallback_windows: int = 0   # non-ASCII or overflow windows
    spliced_pieces: int = 0          # device misses merged on the host
    wall_s: float = 0.0
    bytes_total: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def wall_mbps(self) -> float:
        return self.bytes_total / 1e6 / self.wall_s if self.wall_s else 0.0


class ResidentStream:
    """Four-stage window-pipeline corpus encoder."""

    def __init__(
        self,
        ranks: dict[bytes, int],
        specials: dict[str, int],
        pattern: str,
        *,
        window: int = 1 << 20,
        batch: int = 8,
        cap_bytes_per_piece: float = 3.0,
        profile: str = "llama4",
        device: str | torch.device = "cuda",
        tables: StreamTables | None = None,
    ):
        refuse_kimi("ResidentStream", pattern=pattern, profile=profile)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if window % 1024:
            raise ValueError(f"window {window} is not a multiple of 1024")
        self.window = window
        self.batch = batch
        self.profile = profile
        self.host = HostEngine(pattern, ranks, specials)
        self._splicer = Splicer(self.host.ranks)
        if tables is None:
            tables = tables_from_ranks(ranks, device=self.device)
        self.tables = tables
        self.p_cap = caps_for(window, bytes_per_piece=cap_bytes_per_piece)[
            "p_cap"]
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._h = [self._buffers(pin=True) for _ in range(2)]
            self._d = [self._buffers(device=self.device) for _ in range(2)]
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._done = [torch.cuda.Event() for _ in range(2)]

    def _buffers(self, *, pin: bool = False, device=None):
        kw = dict(pin_memory=True) if pin else dict(device=device)
        return (torch.zeros((self.batch, self.window), dtype=torch.uint8, **kw),
                torch.zeros((self.batch,), dtype=torch.int32, **kw))

    # ------------------------------------------------------------------
    def pipeline(self, data: torch.Tensor, nbytes: torch.Tensor):
        """The four stages on one staged batch: (B, N) uint8 windows and
        (B,) int32 lengths on the stream's device. Returns finalize's
        9-tuple."""
        starts = piece_starts_bits(data, nbytes, profile=self.profile)
        sb, pl, k0, k1, k2, k3, npc = compact_piece_keys(
            starts, data, nbytes, self.p_cap, packed=True)
        rank = vocab_probe8(k0, k1, k2, k3, pl, self.tables.vhash8_rows,
                            self.tables.vhash8_mask)
        return finalize(sb, pl, rank, npc, p_cap=self.p_cap)

    def _stage_windows(self, corpus: bytes):
        """Char-aligned fixed-shape windows + per-window device eligibility
        (non-empty and ASCII)."""
        wins = stream_windows(corpus, self.window)
        metas = [len(w) > 0 and not (w & 0x80).any() for w in wins]
        return wins, metas

    def _fill(self, d: torch.Tensor, nb: torch.Tensor, wins, bidx) -> None:
        d.zero_()
        nb.zero_()
        dn, nbn = d.numpy(), nb.numpy()
        for r, i in enumerate(bidx):
            dn[r, : len(wins[i])] = wins[i]
            nbn[r] = len(wins[i])

    def _stage(self, k: int, wins, bidx):
        """Put batch k on the device; returns its (data, nbytes)."""
        if self.device.type == "cpu":
            d, nb = self._buffers()
            self._fill(d, nb, wins, bidx)
            return d, nb
        slot = k % 2
        h_d, h_nb = self._h[slot]
        d_d, d_nb = self._d[slot]
        self._copied[slot].synchronize()   # batch k-2's copy left h_*
        self._fill(h_d, h_nb, wins, bidx)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._done[slot])  # k-2 read d_*
            d_d.copy_(h_d, non_blocking=True)
            d_nb.copy_(h_nb, non_blocking=True)
            self._copied[slot].record(self._copy_stream)
        return d_d, d_nb

    def _run(self, k: int, staged):
        if self.device.type == "cpu":
            return self.pipeline(*staged)
        slot = k % 2
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self._copied[slot])
        out = self.pipeline(*staged)
        self._done[slot].record(cur)
        return out

    def encode(self, corpus: bytes) -> tuple[list[list[int]], StreamStats]:
        """Encode ``corpus`` window by window (each window an independent
        text). Returns (per-window id lists, stats); the ids equal
        ``HostEngine.encode_ordinary`` of each window."""
        B = self.batch
        wins, dev_ok = self._stage_windows(corpus)
        stats = StreamStats(
            n_windows=len(wins), bytes_total=sum(len(w) for w in wins)
        )
        out: list[list[int] | None] = [None] * len(wins)
        idxs = [i for i, ok in enumerate(dev_ok) if ok]
        batches = [idxs[k : k + B] for k in range(0, len(idxs), B)]
        t0 = time.perf_counter()

        # host-clock split of the wall: staging (window copies into the
        # pinned buffers, H2D enqueue), dispatch (kernel launches), waiting
        # for the device, drain (D2H, splice, id lists)
        clock = dict(stage_s=0.0, dispatch_s=0.0, device_wait_s=0.0,
                     drain_s=0.0)

        def timed(key, fn, *a):
            t = time.perf_counter()
            r = fn(*a)
            clock[key] += time.perf_counter() - t
            return r

        results = []
        staged = timed("stage_s", self._stage, 0, wins,
                       batches[0]) if batches else None
        for k, bidx in enumerate(batches):
            nxt = (timed("stage_s", self._stage, k + 1, wins, batches[k + 1])
                   if k + 1 < len(batches) else None)
            results.append((bidx, timed("dispatch_s", self._run, k, staged)))
            staged = nxt
        if self.device.type == "cuda":
            timed("device_wait_s", torch.cuda.synchronize, self.device)
        t_drain = time.perf_counter()
        # drain + host splice
        for bidx, res in results:
            (flat, n_kept, _np, _nk2, _cons, overflow,
             ms_s, ms_l, n_ms) = [x.cpu().numpy() for x in res]
            for r, i in enumerate(bidx):
                if bool(overflow[r]):
                    continue  # filled by the host pass below
                ids = flat[r][: int(n_kept[r])]
                k_ms = int(n_ms[r])
                if k_ms:
                    stats.spliced_pieces += k_ms
                    ids = self._splicer.splice(ids, wins[i].tobytes(),
                                               ms_s[r], ms_l[r], k_ms)[0]
                out[i] = ids.tolist()
        clock["drain_s"] = time.perf_counter() - t_drain
        stats.n_batches = len(batches)
        stats.wall_s = time.perf_counter() - t0
        stats.extra.update(clock)

        for i, w in enumerate(wins):
            if out[i] is None:
                stats.host_fallback_windows += 1  # non-ASCII or overflow
                out[i] = self.host.encode_ordinary(
                    w.tobytes().decode("utf-8")
                )
        return out, stats  # type: ignore[return-value]
