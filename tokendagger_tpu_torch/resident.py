"""Window-batch harness of the device pipeline: the JAX package's
``resident.run_resident`` on the card.

``run_resident`` stages ``n_windows`` char-aligned windows of a corpus on
the device, runs them through the pipeline ``reps`` times (one batch of
``batch`` of them, or with ``batch=1`` one window a repetition, cycling
through them), and reports the device time of each stage, the wall rate,
the piece count and whether the ids equal the host engine's. The stages
are the reference's choices:

* "general" (``batch > 1``; ``impl="auto"`` takes it when a window holds
  a multi-byte char): the decode ``pretokenize.utf8_decode_tiles`` (K9,
  K5+K6), the piece starts ``bitplane.piece_starts_chars`` (K1, or with
  the hot codepoints K5+K6, K7+K8 and K1's class-word entry), the
  char-to-byte expansion ``pretokenize.expand_starts_replay`` (K7+K8),
  the piece keys ``compact.compact_piece_keys`` (K2+K3), the probe
  (``join.vocab_probe8``, or ``join.vocab_probe_hot`` with K5+K6 and
  K7+K8) and ``compact.finalize`` (K4);
* the fused ASCII pipeline (``batch > 1``, ``impl="ascii-sort"``,
  ``starts_impl="bits-pallas"``, ``compact_impl="butterfly"``): the
  stages of ``ResidentStream.pipeline``;
* every other combination, and ``batch=1``: the decode by ``impl``
  ("ascii-sort" ``utf8_decode_ascii``, "sort" ``utf8_decode_sorted``, else
  ``utf8_decode``: K9 and K4), the starts (``batch=1``:
  ``pretokenize.compute_starts``, K1 on a card; batched: "bits" and
  "bits-pallas" K1's codepoint entry, else the char form
  ``pretokenize.piece_starts``), the keys (``compact_impl="butterfly"``
  K2+K3; else by ``impl``: ``join.compact_piece_keys_sorted``, after
  ``starts_to_bytes`` for "sort", or ``join.compact_piece_keys``), the
  probe and the finalize (butterfly ``compact.finalize``; sorted
  ``fused.finalize_host_sorted``; else ``fused.finalize_host``, K4).
  ``batch=1`` with ``miss_mode="device"`` resolves the window instead
  (``fused.resolve_window``: K2+K3, the probe or sort join, K4 buckets and
  the merge kernel). ``batch=1`` reports ``starts_impl="jnp"`` and
  ``compact_impl="sort"``, as the reference does.

The host side is the reference's: the windowing and char alignment, the
auto piece capacity from exact host piece counts, the hot piece and hot
codepoint sets (``Counter.most_common`` order), the char capacity, the
overflow flags of both hot routes ORed into finalize's, and the check
against the host engine, in which an overflowed window counts as a
mismatch. The reference's four probes return the same ranks; the port has
one probe and reports the name it was given.

The timed repetitions run twice on the card. The first time, CUDA events
around each stage give ``event_us``/``event_ms`` (which include the card's
waits for the host's launches) and the host clock gives ``wall_ms``. The
second time they run under a ``torch.profiler`` trace, one
``record_function`` range per stage, and ``stage_us``/``device_ms`` sum the
kernel, copy and memset durations that each stage launched, as the
reference sums its programs' device time from a trace
(``utils/profiling.stage_device_us``). The trace's kernel events of each
hand-written kernel are counted against the wrappers' launch counters;
``trace_kernel_shortfall`` names any kernel with fewer events than
launches (a trace that lost events). On the CPU there is no device:
``stage_us`` and ``event_us`` are empty and ``device_ms`` 0, as the
reference reports off the TPU.
"""

from __future__ import annotations

import contextlib
import gc
import tempfile
import time
from collections import Counter
from dataclasses import asdict, dataclass

import numpy as np
import torch

from .convert import merge_tables_from_ranks, tables_from_ranks
from .hostengine import HostEngine, byte_pair_merge
from .ops import bitplane, compact, merge, pretokenize
from .ops.bitplane import piece_starts_bits, piece_starts_chars
from .ops.compact import compact_piece_keys, finalize
from .ops.fused import (
    SENTINEL, caps_for, finalize_host, finalize_host_sorted, resolve_window,
)
from .ops.join import compact_piece_keys as join_compact_piece_keys
from .ops.join import (
    compact_piece_keys_sorted, piece_key_words, vocab_probe8,
    vocab_probe_hot,
)
from .ops.pretokenize import (
    compute_starts, expand_starts_replay, piece_starts, starts_to_bytes,
    utf8_decode, utf8_decode_ascii, utf8_decode_sorted, utf8_decode_tiles,
)
from .unicode_tables import get_two_level_tables
from .utils import profiling
from .utils.windows import char_align
from .vocab import refuse_kimi

STAGES = ("decode", "starts", "expand", "compact", "probe", "finalize",
          "resolve")
# each wrapper with a launch counter, and the function name of the CUDA
# kernel it launches (at least once a launch)
TRACED_KERNELS = (
    (pretokenize.utf8_decode_block, "utf8_decode_kernel"),
    (bitplane.piece_starts_bits, "piece_starts_kernel"),
    (bitplane.piece_starts_chars, "piece_starts_cp_kernel"),
    (bitplane.piece_starts_words, "piece_starts_words_kernel"),
    (bitplane.piece_starts_rows, "piece_starts_row_kernel"),
    (compact.compact_piece_keys, "piece_keys_kernel"),
    (compact.compact_by_mask, "mask_compact_kernel"),
    (compact.compact_record, "record_kernel"),
    (compact.expand_route, "route_expand_kernel"),
    (merge.merge_rows, "merge_rows_group"),
    (vocab_probe8, "vocab_probe8_kernel"),
)


@dataclass
class ResidentResult:
    window_bytes: int
    n_windows: int
    reps: int
    calibration_ms: float       # trivial launch + synchronize
    device_ms: float            # device time per batch (profiler trace)
    kernel_mbps: float          # batch*window_bytes / device_ms
    stage_us: dict              # device µs per stage per batch (trace)
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
    event_ms: float = 0.0       # CUDA-event time per batch
    event_us: dict | None = None  # CUDA-event µs per stage per batch
    # kernel name -> {"launches": wrapper launches, "events": the trace's
    # kernel events} over the traced repetitions, for each kernel that ran
    trace_kernels: dict | None = None
    # kernel name -> launches the trace holds no kernel event for
    trace_kernel_shortfall: dict | None = None

    def to_dict(self):
        return asdict(self)


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


def probe_ranks(k0, k1, k2, k3, pl, rows, vmask, probe_hot_cfg=None):
    """The whole-piece probe: (rank, None) from ``vocab_probe8``, or with
    a hot-piece config {hot_keys, hot_ranks, u_cap} ``vocab_probe_hot``'s
    (rank, overflow)."""
    if probe_hot_cfg is None:
        return vocab_probe8(k0, k1, k2, k3, pl, rows, vmask), None
    return vocab_probe_hot(
        k0, k1, k2, k3, pl, rows, vmask,
        hot_keys=probe_hot_cfg["hot_keys"],
        hot_ranks=probe_hot_cfg["hot_ranks"],
        u_cap=probe_hot_cfg["u_cap"])


def _or_overflow(out: tuple, flags) -> tuple:
    """finalize's 9-tuple with each (B,) overflow flag of ``flags`` that
    is not None ORed into [5]."""
    for ovf in flags:
        if ovf is not None:
            out = out[:5] + (out[5] | ovf,) + out[6:]
    return out


def batch_pipeline(d: torch.Tensor, nb: torch.Tensor, *, impl: str,
                   p_cap: int, rows: torch.Tensor, vmask: int,
                   profile: str = "llama4", c_cap: int | None = None,
                   packed: bool = True, hot_cps=None,
                   u_cap: int | None = None, probe_hot_cfg=None,
                   stage=contextlib.nullcontext):
    """The batched pipelines built from K2+K3 and ``compact.finalize``,
    on (B, N) uint8 complete windows and their (B,) int32 lengths, each
    stage inside ``stage(name)``; ``run_resident`` and
    ``parallel/resident_mesh`` run them.

    * impl "general" (any UTF-8): ``utf8_decode_tiles`` to ``c_cap``
      chars (K9, K5+K6), ``piece_starts_chars`` (K1's codepoint entry,
      or with ``hot_cps`` and ``u_cap`` the hot-codepoint classes and its
      class-word entry), ``expand_starts_replay`` (K7+K8) and
      ``compact_piece_keys`` on byte flags (K2+K3);
    * impl "ascii" (every byte below the length ASCII, N % 1024 == 0):
      ``piece_starts_bits`` (K1's byte entry) and ``compact_piece_keys``
      on its plane words when ``packed``, else on byte flags;

    then ``probe_ranks`` (``probe_hot_cfg``: the hot-piece route, K5+K6
    and K7+K8) and ``compact.finalize`` (K4). Returns finalize's 9-tuple
    with both hot routes' overflow flags ORed into [5]."""
    cls_ovf = None
    if impl == "general":
        with stage("decode"):
            cp, lead, m, route = utf8_decode_tiles(d, nb, c_cap=c_cap)
        with stage("starts"):
            if hot_cps is not None:
                st_c, cls_ovf = piece_starts_chars(
                    cp, m, profile=profile, hot_cps=hot_cps, u_cap=u_cap)
            else:
                st_c = piece_starts_chars(cp, m, profile=profile)
        with stage("expand"):
            starts = expand_starts_replay(st_c, lead, route)
        with stage("compact"):
            keys = compact_piece_keys(starts, d, nb, p_cap)
    elif impl == "ascii":
        with stage("starts"):
            starts = piece_starts_bits(d, nb, profile=profile,
                                       packed_out=packed)
        with stage("compact"):
            keys = compact_piece_keys(starts, d, nb, p_cap, packed=packed)
    else:
        raise ValueError(f"impl must be 'general' or 'ascii', got {impl!r}")
    sb, pl, k0, k1, k2, k3, npc = keys
    with stage("probe"):
        rank, p_ovf = probe_ranks(k0, k1, k2, k3, pl, rows, vmask,
                                  probe_hot_cfg)
    with stage("finalize"):
        out = finalize(sb, pl, rank, npc, p_cap=p_cap)
    return _or_overflow(out, [cls_ovf, p_ovf])


def _traced_stage_us(pipeline, wins, reps: int) -> tuple[dict, dict]:
    """``reps`` repetitions of ``pipeline`` under a profiler trace, each
    stage in a ``record_function`` range: the device µs each stage
    launched, summed over the repetitions, and per hand-written kernel
    that ran its wrapper launches and the trace's kernel events."""
    with tempfile.TemporaryDirectory() as d:
        with profiling.profile_trace(d):
            # one repetition outside the ranges first: a trace can lose
            # the kernels launched while tracing starts (the first
            # decode kernel of 20 repetitions, on the H100)
            pipeline(*wins[0])
            torch.cuda.synchronize()
            before = [fn.launches for fn, _ in TRACED_KERNELS]
            for r in range(reps):
                pipeline(*wins[r % len(wins)],
                         torch.profiler.record_function)
            torch.cuda.synchronize()
        events = profiling.trace_events(d)
    seen = profiling.kernel_counts(events, [n for _, n in TRACED_KERNELS],
                                   STAGES)
    kernels = {}
    for (fn, name), b in zip(TRACED_KERNELS, before):
        if fn.launches - b or seen[name]:
            kernels[name] = {"launches": fn.launches - b,
                             "events": seen[name]}
    return profiling.stage_device_us(events, STAGES), kernels


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
    join_mode: str = "probe",  # read under miss_mode="device"
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
    """Run the device pipeline over windows of ``corpus`` and return a
    ``ResidentResult`` (see the module doc). Arguments are the
    reference's plus ``device``: the card by default (raises without
    one), ``"cpu"`` for the kernels' plain versions.

    ``cap_bytes_per_piece`` 0 sizes the piece slots from exact host piece
    counts, and with ``batch > 1``, ``probe_impl="chunks"`` and
    ``miss_mode="host"`` routes the hot pieces (and on the general
    pipeline, windows a multiple of 32768, the hot codepoints). As in the
    reference, ``batch > 1`` requires ``miss_mode="host"`` (ValueError
    otherwise), ``join_mode`` is read only by the single-window pipeline
    under ``miss_mode="device"``, and any other ``miss_mode`` reports the
    probe as "barrier"."""
    refuse_kimi("run_resident", pattern=pattern, profile=profile)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if batch > 1 and miss_mode != "host":
        raise ValueError("batched resident mode requires miss_mode='host'")
    if trials != 1:
        raise ValueError("run_resident runs one trial (the reference "
                         "ignores trials)")
    if miss_mode != "host":
        probe_impl = "barrier"  # resolve_window has one probe
    on_card = dev.type == "cuda"
    batched = batch > 1
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
        if all_ascii and miss_mode == "host":
            impl = "ascii-sort"
        elif batched and miss_mode == "host":
            impl = "general"
        else:
            impl = "sort"
    if impl == "general":
        starts_impl = "bits-pallas"
        compact_impl = "butterfly"
    if batched and compact_impl == "butterfly" and impl not in (
            "ascii-sort", "general"):
        compact_impl = "sort"
    # the batched pipelines built from K2+K3 and compact.finalize
    butterfly = batched and compact_impl == "butterfly"
    general = batched and impl == "general"
    fused_ascii = (butterfly and impl == "ascii-sort"
                   and starts_impl == "bits-pallas")

    # ---- capacities (resident.py:175-263) ------------------------------
    cap_auto = not cap_bytes_per_piece
    probe_hot_cfg = None
    if cap_auto:
        h_sizer = HostEngine(pattern, ranks, specials)
        max_pieces = max((len(h_sizer.split_spans(b.decode("utf-8")))
                          for b in win_bytes), default=1)
        p_tight = max(512, -(-int(max_pieces * 1.02 + 8) // 128) * 128)
        cap_bytes_per_piece = round(N / p_tight, 2)
        if batched and probe_impl == "chunks" and miss_mode == "host":
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
    if general:
        c_cap = _char_capacity(N, max_chars, cap_auto)
        if cap_auto and N % 32768 == 0:
            hot_cps, u_cap, c_cap = _hot_codepoints(win_bytes, N, c_cap)

    tables = tables_from_ranks(ranks, device=dev)
    rows, vmask = tables.vhash8_rows, tables.vhash8_mask
    page_ids, pages = (torch.from_numpy(a.astype(np.int64)).to(dev)
                       for a in get_two_level_tables())
    contractions = profile != "nocontract"
    mt = (merge_tables_from_ranks(ranks, device=dev)
          if miss_mode != "host" else None)

    # ---- the reference's stage choices (resident.py:344-365, 396-609) --
    def decode(d, nb):
        if impl == "ascii-sort":
            return utf8_decode_ascii(d, nb)
        if impl == "sort":
            return utf8_decode_sorted(d, nb)
        return utf8_decode(d, nb)

    def starts_of(cp, m):
        if not batched:
            return compute_starts(cp, m, page_ids, pages,
                                  contractions=contractions, profile=profile)
        if starts_impl in ("bits", "bits-pallas"):
            return piece_starts_chars(cp, m, profile=profile)
        return piece_starts(cp, m, page_ids, pages,
                            contractions=contractions, profile=profile)

    def compact_of(st, cob, boc, d, nb):
        if butterfly:
            return compact_piece_keys(st, d, nb, p_cap)
        if impl == "ascii-sort":
            return compact_piece_keys_sorted(st, d, nb, p_cap)
        if impl == "sort":
            return compact_piece_keys_sorted(
                starts_to_bytes(st, cob, d, nb), d, nb, p_cap)
        return join_compact_piece_keys(st, boc, d, nb, p_cap)

    def finalize_of(sb, pl, rank, npc):
        if butterfly:
            return finalize(sb, pl, rank, npc, p_cap=p_cap)
        if impl in ("ascii-sort", "sort"):
            # complete windows: the kept pieces are the live ones
            return finalize_host_sorted(sb, pl, rank, npc, N, p_cap=p_cap,
                                        untrimmed=True)
        return finalize_host(sb, pl, rank, npc, N, p_cap=p_cap)

    def pipeline(d, nb, stage=contextlib.nullcontext):
        """One batch (a (1, N) window when batch=1) through the stages,
        each inside ``stage(name)``. Returns finalize's 9-tuple with
        every overflow ORed into [5]."""
        if general or fused_ascii:
            return batch_pipeline(
                d, nb, impl="general" if general else "ascii", p_cap=p_cap,
                rows=rows, vmask=vmask, profile=profile, c_cap=c_cap,
                hot_cps=hot_cps, u_cap=u_cap, probe_hot_cfg=probe_hot_cfg,
                stage=stage)
        with stage("decode"):
            cp, cob, boc, m = decode(d, nb)
        with stage("starts"):
            starts = starts_of(cp, m)
        if miss_mode != "host":
            with stage("resolve"):
                return resolve_window(
                    starts, boc, d, nb, N, mt.byte_rank, mt.pair_rows,
                    mt.pair_lut, mt.vk, mt.vlen, mt.vrank, rows,
                    mask=mt.pair_mask, vhash_mask=vmask,
                    join_mode=join_mode, miss_mode=miss_mode, **caps)
        with stage("compact"):
            sb, pl, k0, k1, k2, k3, npc = compact_of(starts, cob, boc, d, nb)
        with stage("probe"):
            rank, p_ovf = probe_ranks(k0, k1, k2, k3, pl, rows, vmask,
                                      probe_hot_cfg)
        with stage("finalize"):
            out = finalize_of(sb, pl, rank, npc)
        return _or_overflow(out, [p_ovf])

    # every window on the device before timing: one batch of ``batch``
    # windows, or each window alone, cycled through (resident.py:701)
    if batched:
        sel = [[i % n_windows for i in range(batch)]]
    else:
        sel = [[w] for w in range(n_windows)]
    h_wins = [(torch.from_numpy(np.stack([bufs[i] for i in ix])),
               torch.tensor([len(win_bytes[i]) for i in ix],
                            dtype=torch.int32)) for ix in sel]
    wins = [(d.to(dev), nb.to(dev)) for d, nb in h_wins]

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
    pipeline(*wins[0])
    sync()
    gc.collect()

    # ---- timed repetitions: CUDA events around the stages -------------
    marks: list = []

    @contextlib.contextmanager
    def event_stage(name: str):
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        marks.append((name, a, b))

    t0 = time.perf_counter()
    last = None
    for r in range(reps):
        d, nb = wins[r % len(wins)]
        last = pipeline(d, nb, event_stage if on_card
                        else contextlib.nullcontext)
    total_tokens = int(last[1].sum())   # the one read that drains the queue
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    overflow_windows = int(last[5].sum())
    event_tot: dict[str, float] = {}
    for name, a, b in marks:
        event_tot[name] = event_tot.get(name, 0.0) + a.elapsed_time(b) * 1e3
    event_us = {k: round(v / reps, 2) for k, v in sorted(event_tot.items())}
    event_ms = sum(event_tot.values()) / reps / 1e3

    # ---- the same repetitions under a profiler trace: device time ------
    stage_us: dict = {}
    device_ms = 0.0
    kernels: dict = {}
    if on_card:
        stage_tot, kernels = _traced_stage_us(pipeline, wins, reps)
        stage_us = {k: round(v / reps, 2) for k, v in sorted(
            stage_tot.items())}
        device_ms = sum(stage_tot.values()) / reps / 1e3

    # ---- H2D/compute overlap trial (resident.py:728-778) ----------------
    overlap_stats = None
    if batched and overlap_trial:
        overlap_stats = _overlap_trial(pipeline, bufs, win_bytes, batch,
                                       n_windows, N, dev)

    match = True
    if verify:
        out = [o.cpu().numpy() for o in pipeline(*wins[0])]
        h_stk, h_nb = h_wins[0]
        host = HostEngine(pattern, ranks, specials)
        rdict = dict(ranks)
        match = all(
            _check_window(tuple(o[b] for o in out),
                          h_stk[b, : int(h_nb[b])].numpy().tobytes(), host,
                          rdict)
            for b in range(len(h_nb)))

    per_batch_bytes = N * max(batch, 1)
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
        batch=max(batch, 1),
        impl=impl,
        starts_impl=starts_impl if batched else "jnp",
        compact_impl=compact_impl if batched else "sort",
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
        event_ms=round(event_ms, 4),
        event_us=event_us,
        trace_kernels=kernels,
        trace_kernel_shortfall={
            k: v["launches"] - v["events"] for k, v in kernels.items()
            if v["launches"] > v["events"]},
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
