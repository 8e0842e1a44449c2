"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--mb 16] [--engine-mb 12]

1. Builds the CUDA kernels of tokendagger_tpu_torch (one nvcc per source,
   in parallel) and prints the card, its power limit and the build time.
2. Holds each kernel of the ASCII window pipeline against its plain torch
   version on the card, at that path's shapes (8 windows of 1 MB,
   p_cap 349,568), on seeded ASCII windows plus edge cases (an empty
   window, a one-piece window, punctuation that overflows p_cap, a length
   that is not a multiple of 32, garbage bytes beyond the length). Every
   output must be equal. Each kernel gets two times: ``ms``, device-only
   (CUDA events around a run of launches enqueued while the card is
   busy, so the host's time between launches is not counted), and
   ``call_ms``, one call with a synchronize after it; both beside its
   bound and the plain version's time. A library yardstick
   (``masked_select``, ``masked_scatter_``) gets its device time from a
   torch.profiler trace, since it synchronizes on the host. K4 must run
   one kernel per call; K1 must spread each window over many blocks.
3. Holds the kernels of the public API's engine against their plain
   versions at the engine's shapes: the UTF-8 decode (K9) on 4 MB and
   16 MB windows of seeded multi-script text and invalid UTF-8, and K1's
   codepoint entry on 4 MB and 16 MB multi-script windows (with an empty
   window and a ragged length inside the first segment) for all four
   profiles.
   After step 5's run, every kernel of the engine's window pipeline (K9,
   K4 in the decode's compaction, K1, K2+K3, K4 in finalize) is held
   against its plain version stage by stage on one 4 MB window and on
   one grown 16 MB window of that run's texts, and K4 is timed at the
   decode's and finalize_host's shapes there.
4. Drives ResidentStream on the card over at least 16 MB with a seeded
   200,000-rank stand-in vocabulary, checks the first batch's ids against
   the host engine, no host fallback, and one launch of each kernel per
   batch, and prints the wall rate and per-stage times, and the device's
   idle share of one more encode under torch.profiler.
5. Drives Tokenizer(backend="device") over at least 12 MB of seeded
   multi-script text with specials sprinkled over its last third, so
   that the first 8 MB segment runs in 4 MB windows cut at safe offsets
   (a 200,000-rank stand-in that also holds the text's own pieces):
   encode, a 64-text encode_batch and the device decode must equal the
   host engine and the text. Prints the wall rate with its host-clock
   split, the device's idle share of one more encode under
   torch.profiler, the kernels' launches per window, the per-stage
   device times of one 4 MB window, and the wall rate of an ordinary
   encode with 1 MB
   and with 4 MB windows of the same text plus a 5 MB digit run (one
   class run, so windows grow to 16 MB), whose ids must equal the host
   engine's.
6. Drives run_resident, the batched general pipeline, on the card at
   full width: 8 windows of 1 MB of seeded multi-script text with the
   engine's stand-in vocabulary, once with the explicit capacity 3.0 and
   once with the auto capacity (both hot routes: hot codepoints and hot
   pieces). Each run's ids must equal the host engine's with no overflow,
   and every kernel of the path must have launched. Prints each run's
   kernel_mbps, device_ms, stage_us, wall_mbps and overlap dict. Then
   holds K5+K6 (compact_record), K7+K8 (expand_route) and K1's class-word
   entry (all four profiles) against their plain versions on the inputs
   the auto run gave them at each of the path's shapes (the decode, the
   hot-codepoint classes, the hot-piece probe), and on the same shapes
   with an empty row, an all-kept (overflowing) row and a skewed row;
   and K9, K1's codepoint entry (all four profiles), K2+K3 and K4 on the
   inputs each run gave them, with an edge row each. Every kernel's
   times at the path's shapes join its row of the kernels line.
7. Prints a "kernels" JSON line, then the card's name and power limit, and
   last {"ok": true, "device": {...}}. Any failure exits non-zero first.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT_OPS_PER_S = 67e12       # H100 SXM 32-bit non-tensor rate (fp32 figure)
WINDOW, BATCH = 1 << 20, 8
ENGINE_WINDOW = 1 << 22     # the engine's card window (engine.CARD_WINDOW)
MAX_WINDOW = 1 << 24        # its largest, grown window (engine.MAX_WINDOW)

WORDS = (
    "the of and to in a is that for it as was with be by on not he this are "
    "or his from at which but have an they you were her she all would there "
    "their we him been has when who will no more if out so said what up its "
    "about into than them can only other new some could time these two may "
    "then do first any my now such like our over man me even most made after "
    "also did many before must through back years where much your way well "
    "down should because each just those people Mr how too little state good "
    "very make world still own see men work long get here between both life "
    "being under never day same another know while last might us great old "
    "year off come since against go came right used take three"
).split()
CODE = [
    "    def f(x):\n        return x**2\n",
    "for (int i = 0; i < n; ++i) { a[i] += b[i]; }\n",
    "    if err != nil {\n        return err\n    }\n",
    "x = [1, 2, 3]  # list\n",
    "<div class=\"row\">{{ item.name }}</div>\n",
]


def corpus(n_bytes: int, seed: int) -> str:
    """English-like sentences with numbers and code lines (ASCII)."""
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < n_bytes:
        k = int(rng.integers(6, 20))
        s = " ".join(WORDS[i] for i in rng.integers(len(WORDS), size=k))
        s = s.capitalize()
        r = rng.random()
        if r < 0.15:
            s += f" {int(rng.integers(0, 10**7))}"
        elif r < 0.25:
            s += " don't they'll I'm"
        s += [". ", "! ", "? ", ".\n\n"][int(rng.integers(4))]
        if rng.random() < 0.05:
            s += CODE[int(rng.integers(len(CODE)))]
        parts.append(s)
        size += len(s)
    return "".join(parts)[:n_bytes]


# multi-script words: Latin accents, Greek, Cyrillic, CJK, Arabic, Hebrew,
# emoji (ZWJ, skin tone, flags), combining marks, other digits, and the
# fold letters U+017F / U+212A after apostrophes
SCRIPT_WORDS = (
    "café naïve Übermäßig schön Ça résumé ÉCOLE ǅemal Γειά σου Κόσμε ΑΘΗΝΑ "
    "λόγος Здравствуйте мир МОСКВА ёлка 日本語 中文文本 テキスト 한국어 の "
    "مرحبا שלום עולם 🙂 👍🏽 🇺🇸 🎉🎉 e\u0301\u0302 à a\u0308 ٣٤ ²³ Ⅻ "
    "I'\u017fT x'\u212a it'\u017f \u3000x"
).split(" ") + ["👩\u200d👩\u200d👧", "\u3000", "\u3000\u3000", "\u00a0"]
SEPARATORS = [" ", " ", " ", " ", ", ", ". ", "\n", "\u3000", "'s ",
              "'LL ", " 12 ", "! ", "\n\n", " - "]
SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>", "<|eot|>",
            "<|header_start|>", "<|header_end|>", "<|python_start|>",
            "<|image|>", "<|finetune_right_pad|>")


def multiscript(n_bytes: int, seed: int) -> str:
    """About n_bytes of seeded text: the English word list and the
    multi-script words, mixed, with punctuation, digits and contractions."""
    rng = np.random.default_rng(seed)
    words = WORDS + SCRIPT_WORDS
    parts, size = [], 0
    while size < n_bytes:
        k = 1 << 16
        w = rng.integers(len(words), size=k)
        sp = rng.integers(len(SEPARATORS), size=k)
        chunk = "".join(words[i] + SEPARATORS[j] for i, j in zip(w, sp))
        parts.append(chunk)
        size += len(chunk.encode())
    raw = "".join(parts).encode()[:n_bytes]
    return raw.decode("utf-8", errors="ignore")


def with_specials(text: str, seed: int, every: int = 1 << 16,
                  start: int = 0) -> str:
    """``text`` with one of SPECIALS inserted about every ``every`` chars
    from char ``start`` on."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(start, len(text),
                                (len(text) - start) // every))
    parts, prev = [], 0
    for c in cuts.tolist():
        parts += [text[prev:c], SPECIALS[int(rng.integers(len(SPECIALS)))]]
        prev = c
    return "".join(parts + [text[prev:]])


@functools.lru_cache(maxsize=2)
def standin_vocab(n_ranks: int, seed: int,
                  extra: str | None = None) -> dict[bytes, int]:
    """256 bytes, every pretoken of a seeded corpus sample (and of
    ``extra``) with all its byte prefixes, then seeded random ASCII
    strings of 2-16 bytes."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine

    ranks = {bytes([i]): i for i in range(256)}
    host = HostEngine(LLAMA4_PATTERN, ranks, {})
    for sample in (corpus(1 << 20, seed + 1), extra or ""):
        for a, b in host.split_spans(sample):
            p = sample[a:b].encode()
            for k in range(2, len(p) + 1):
                ranks.setdefault(p[:k], len(ranks))
    rng = np.random.default_rng(seed + 2)
    while len(ranks) < n_ranks:
        k = int(rng.integers(2, 17))
        ranks.setdefault(bytes(rng.integers(32, 127, k).astype(np.uint8)),
                         len(ranks))
    return ranks


def edge_windows(seed: int, n: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """8 windows: prose, prose with a ragged length and garbage tail, empty,
    one piece, overflowing punctuation, dense mixed classes, code, digits."""
    rng = np.random.default_rng(seed)
    texts = [
        corpus(n, seed + 10),
        corpus(n - 12345, seed + 11),
        "",
        "a" * n,
        "! " * (n // 2),
        "".join(rng.choice(list("aZ09 '\t\n\r/.,!?-_sStTlLdDmMvVeErR"),
                           n)),
        "".join(CODE[int(i)] for i in rng.integers(len(CODE), size=n // 20)),
        " ".join(str(int(x)) for x in rng.integers(0, 10**9, n // 6)),
    ]
    by = rng.integers(0, 256, (len(texts), n)).astype(np.uint8)
    nb = np.zeros(len(texts), np.int32)
    for b, t in enumerate(texts):
        raw = t.encode("ascii")[:n]
        by[b, : len(raw)] = np.frombuffer(raw, np.uint8)
        nb[b] = len(raw)
    return torch.from_numpy(by).to(dev), torch.from_numpy(nb).to(dev)


def median_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median time of one synchronized call of ``fn`` (CUDA events around
    each call, a synchronize after it): a short kernel's reading includes
    its wrapper's host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, runs: int = 5, warmup: int = 2) -> float:
    """Device-only time of one call of ``fn``, which must not synchronize:
    a CUDA event, ``reps`` calls enqueued back to back on inputs prepared
    beforehand, another event, one synchronize; the median over ``runs``
    such runs of the time between the events over ``reps``. A sleep
    kernel queued before the first event keeps the card busy while the
    host enqueues the calls, so the host's time between launches is not
    counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-4)))  # cycles, <= 2 GHz
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def traced(fn, reps: int = 10) -> tuple[float, float]:
    """Device time and kernel count of one call of ``fn`` from a short
    torch.profiler trace of ``reps`` calls: the union of their kernel,
    copy and memset intervals, and their kernels, each over ``reps``. For
    library calls that synchronize on the host (``masked_select`` must
    learn its output size), where events around a run of calls would
    count the host's gaps."""
    import tempfile

    from tokendagger_tpu_torch.utils.profiling import (
        device_busy_us, profile_trace,
    )

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profile_trace(d):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us, n = device_busy_us(d)
    if not n:
        raise AssertionError("the profiler trace holds no kernels")
    return busy_us / 1e3 / reps, n / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def timings(fn, plain, n_bytes: float, n_ops: float,
            plain_reps: int = 5) -> dict:
    """A kernel's device-only time (``ms``), its synchronized call time
    (``call_ms``), its plain version's call time and its bound."""
    bms, bby = bound(n_bytes, n_ops)
    return dict(ms=device_ms(fn), call_ms=median_ms(fn),
                plain_ms=median_ms(plain, reps=plain_reps), bound_ms=bms,
                bound_by=bby)


def library(fn, what: str) -> dict:
    """A library yardstick: device time from a trace, synchronized call
    time, and what it computes."""
    return dict(library_ms=traced(fn)[0], library_call_ms=median_ms(fn),
                library=what)


def show(t: dict) -> str:
    s = (f"{t['ms']:.4f} ms on the device ({t['call_ms']:.4f} ms per "
         f"synchronized call; plain {t['plain_ms']:.3f} ms, bound "
         f"{t['bound_ms']:.5f} ms by {t['bound_by']})")
    if t.get("library_ms") is not None:
        s += (f"; {t['library']}: {t['library_ms']:.4f} ms on the device, "
              f"{t['library_call_ms']:.4f} ms per call")
    return s


def k1_blocks(entry: str, B: int, N: int) -> int:
    """K1's blocks per window at (B, N); fails unless a launch uses at
    least min(132, 16 B) blocks (for windows of at least 132 words)."""
    from tokendagger_tpu_torch.ops import bitplane as BP

    spw = BP.starts_blocks_per_window(entry, B, N)
    if spw < 2 or spw * B < min(132, 16 * B, N // 32):
        raise AssertionError(f"K1 {entry} at {(B, N)}: {spw} blocks per "
                             "window")
    return spw


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} "
                                 f"vs {w.shape} {w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def check_kernels(seed: int, dev) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops.fused import caps_for

    p_cap = caps_for(WINDOW)["p_cap"]
    by, nb = edge_windows(seed, WINDOW, dev)
    B, N = by.shape
    rows = []

    # ---- K1: piece starts, every profile ----
    k1_err = 0
    for prof in ("llama4", "nocontract", "cl100k", "gpt2"):
        got = BP.piece_starts_bits(by, nb, profile=prof)
        want = BP.piece_starts_bits_plain(by, nb, profile=prof)
        err = max_abs_err([got], [want])
        print(f"K1 piece_starts[{prof}]: max_abs_err {err}")
        if err:
            bad = (got != want).nonzero()[:5].tolist()
            raise AssertionError(f"K1 {prof} differs at {bad}")
        k1_err = max(k1_err, err)
    starts = BP.piece_starts_bits(by, nb, profile="llama4")
    passes = BP.starts_passes("llama4", N)
    spw = k1_blocks("bytes", B, N)
    t = timings(lambda: BP.piece_starts_bits(by, nb, profile="llama4"),
                lambda: BP.piece_starts_bits_plain(by, nb, profile="llama4"),
                B * N + B * N / 8 + 4 * B, passes * B * N / 32, plain_reps=3)
    print(f"K1 piece_starts {(B, N)}: {show(t)}; {passes} passes over the "
          f"planes, {spw} blocks per window")
    rows.append(dict(
        name="piece_starts", route="cuda",
        source="tokendagger_tpu_torch/csrc/piece_starts.cu",
        replaces="tokendagger_tpu/ops/bitplane.py:1152",
        max_abs_err=k1_err, **t, library_ms=None, passes=passes,
        blocks_per_window=spw))

    # ---- K2+K3: piece keys (packed flags from K1, and byte flags) ----
    got = CP.compact_piece_keys(starts, by, nb, p_cap, packed=True)
    want = CP.compact_piece_keys_plain(starts, by, nb, p_cap, packed=True)
    err = max_abs_err(got, want)
    flags = BP.unpack_mask(starts)
    got_b = CP.compact_piece_keys(flags, by, nb, p_cap)
    err = max(err, max_abs_err(got_b, want))
    npc = got[6].tolist()
    print(f"K2+K3 compact_piece_keys: max_abs_err {err}; n_pieces {npc} "
          f"(p_cap {p_cap})")
    if err:
        raise AssertionError("K2+K3 differs from its plain version")
    if not (max(npc) > p_cap and min(npc) == 0):
        raise AssertionError("edge windows did not cover overflow and empty")
    k23_err = err
    idx = torch.arange(N, device=dev).expand(B, N)
    key_bytes = int(torch.clamp(got[1], max=16).sum())
    t = timings(lambda: CP.compact_piece_keys(starts, by, nb, p_cap,
                                              packed=True),
                lambda: CP.compact_piece_keys_plain(starts, by, nb, p_cap,
                                                    packed=True),
                B * N / 8 + key_bytes + 4 * B + 24 * B * p_cap + 4 * B, B * N)
    t.update(library(lambda: torch.masked_select(idx, flags),
                     "masked_select of the start positions only (no keys, "
                     "no lengths)"))
    print(f"K2+K3 compact_piece_keys: {show(t)}")
    rows.append(dict(
        name="compact_piece_keys", route="cuda",
        source="tokendagger_tpu_torch/csrc/compact.cu",
        replaces="tokendagger_tpu/ops/compact_pallas.py:288 (compact_tiles) "
                 "+ :561 (degap_keys)",
        max_abs_err=k23_err, **t))

    # ---- K4: miss-span compaction at finalize's shapes ----
    sb, pl = got[0], got[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    live = torch.arange(p_cap, device=dev) < torch.clamp(got[6], max=p_cap)[:, None]
    miss = live & (torch.rand((B, p_cap), generator=g, device=dev) < 0.05)
    miss[0] = live[0]          # every live slot missed
    k_got = CP.compact_by_mask([sb, pl], miss)
    k_want = CP.compact_by_mask_plain([sb, pl], miss)
    err = k4_err = max_abs_err(k_got, k_want)
    n_kern = traced(lambda: CP.compact_by_mask([sb, pl], miss))[1]
    print(f"K4 compact_by_mask: max_abs_err {err}; {n_kern} kernel per call")
    if err:
        raise AssertionError("K4 differs from its plain version")
    if n_kern != 1:
        raise AssertionError(f"K4 ran {n_kern} kernels in one call")
    both = torch.stack([sb, pl])
    kept = int(miss.sum())
    t = timings(lambda: CP.compact_by_mask([sb, pl], miss),
                lambda: CP.compact_by_mask_plain([sb, pl], miss),
                B * p_cap + 8 * kept + 8 * B * p_cap, B * p_cap)
    t.update(library(lambda: torch.masked_select(both, miss),
                     "masked_select of both arrays"))
    print(f"K4 compact_by_mask {(B, p_cap)}, k 2, {kept} kept: {show(t)}")
    rows.append(dict(
        name="compact_by_mask", route="cuda",
        source="tokendagger_tpu_torch/csrc/compact.cu",
        replaces="tokendagger_tpu/ops/compact_pallas.py:830",
        max_abs_err=k4_err, **t))
    return rows


def utf8_windows(seed: int, n: int, dev) -> list[torch.Tensor]:
    """(1, n) uint8 windows: multi-script text, the same laced with stray
    continuations, 0xF5-0xFF leads and truncated sequences, 4-byte emoji,
    and random bytes."""
    rng = np.random.default_rng(seed)
    text = multiscript(n, seed).encode()
    bad = np.frombuffer(text, np.uint8).copy()
    at = rng.integers(0, len(bad), len(bad) // 64)
    bad[at] = rng.choice(np.array([0x80, 0xBF, 0xC3, 0xE2, 0xF0, 0xF5, 0xF8,
                                   0xFF], np.uint8), len(at))
    raws = [text, bad[:-3].tobytes() + b"\xf0\x9f\x99",
            "\U0001f642".encode() * (n // 4),
            rng.integers(0, 256, n).astype(np.uint8).tobytes()]
    out = []
    for raw in raws:
        buf = np.zeros((1, n), np.uint8)
        buf[0, : len(raw)] = np.frombuffer(raw[:n], np.uint8)
        out.append(torch.from_numpy(buf).to(dev))
    return out


def check_engine_kernels(seed: int, dev) -> list[dict]:
    """K9 and K1's codepoint entry against their plain versions at the
    engine's shapes (one window of 4 MB, or 16 MB grown)."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import pretokenize as PT

    rows = []
    # ---- K9: UTF-8 decode, 4 MB windows and a 16 MB one ----
    wins = utf8_windows(seed, ENGINE_WINDOW, dev)
    wins.append(utf8_windows(seed + 1, 4 * ENGINE_WINDOW, dev)[0])
    err = 0
    for w in wins:
        err = max(err, max_abs_err(PT.utf8_decode_block(w),
                                   PT.utf8_decode_block_plain(w)))
    print(f"K9 utf8_decode_block: max_abs_err {err} over {len(wins)} "
          "windows (4 x 4 MB, 1 x 16 MB)")
    if err:
        raise AssertionError("K9 differs from its plain version")
    timing = {}
    for name, w in (("4 MB", wins[0]), ("16 MB", wins[-1])):
        n = w.numel()
        timing[name] = timings(lambda: PT.utf8_decode_block(w),
                               lambda: PT.utf8_decode_block_plain(w),
                               9 * n, 20 * n)
        print(f"K9 utf8_decode_block {name}: {show(timing[name])}")
    rows.append(dict(
        name="utf8_decode_block", route="cuda",
        source="tokendagger_tpu_torch/csrc/utf8.cu",
        replaces="tokendagger_tpu/ops/pallas_scan.py:91",
        max_abs_err=err, **timing["4 MB"], library_ms=None,
        **by_shape({"engine 16 MB (1, 16777216)": timing["16 MB"]})))

    # ---- K1, codepoint entry: 4 MB multi-script windows and a 16 MB one,
    # each also with an empty window and a ragged length inside the first
    # segment, garbage after ----
    cp_err = 0
    timing = {}
    for label, wl in (("4 MB", wins[:2]), ("16 MB", wins[-1:])):
        N = wl[0].shape[1]
        nb = torch.tensor([N], dtype=torch.int32, device=dev)
        cps = [PT.utf8_decode(w, nb)[::3] for w in wl]
        for n in (0, 12345):
            cps.append((cps[0][0], torch.tensor([n], dtype=torch.int32,
                                                device=dev)))
        for prof in ("llama4", "nocontract", "cl100k", "gpt2"):
            err = 0
            for cp, m in cps:
                got = BP.piece_starts_chars(cp, m, profile=prof,
                                            packed_out=True)
                want = BP.piece_starts_chars_plain(cp, m, profile=prof)
                err = max(err, max_abs_err([got], [want]))
            print(f"K1 piece_starts_cp[{prof}] {label}: max_abs_err {err}")
            if err:
                raise AssertionError(f"K1 codepoint entry {prof} differs at "
                                     f"{label}")
            cp_err = max(cp_err, err)
        cp, m = cps[0]
        passes = BP.starts_passes("llama4", N)
        timing[label] = timings(
            lambda: BP.piece_starts_chars(cp, m, packed_out=True),
            lambda: BP.piece_starts_chars_plain(cp, m),
            4 * N + N / 8 + 4, passes * N / 32, plain_reps=3)
        timing[label].update(passes=passes,
                             blocks_per_window=k1_blocks("codepoints", 1, N))
        print(f"K1 piece_starts_cp (one {label} window): "
              f"{show(timing[label])}; {passes} passes, "
              f"{timing[label]['blocks_per_window']} blocks per window")
    rows.append(dict(
        name="piece_starts_cp", route="cuda",
        source="tokendagger_tpu_torch/csrc/piece_starts.cu",
        replaces="tokendagger_tpu/ops/bitplane.py:1152",
        max_abs_err=cp_err, **timing["4 MB"], library_ms=None,
        **by_shape({"engine 16 MB (1, 16777216)": timing["16 MB"]})))
    return rows


SHAPE_KEYS = ("ms", "call_ms", "plain_ms", "bound_ms", "blocks_per_window")


def by_shape(times: dict) -> dict:
    """{shape: timings} -> {"ms_by_shape": {shape: ms}, ...} for the keys
    of SHAPE_KEYS the timings hold."""
    out: dict = {}
    for shape, t in times.items():
        for k in SHAPE_KEYS:
            if k in t:
                out.setdefault(f"{k}_by_shape", {})[shape] = t[k]
    return out


def run_stream(seed: int, mb: int, dev, *, window=WINDOW, batch=BATCH,
               n_ranks=200_000) -> dict:
    """ResidentStream over >= mb MB; returns the kernels' launch counts."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, ResidentStream
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.utils.windows import stream_windows

    t = time.perf_counter()
    ranks = standin_vocab(n_ranks, seed)
    text = corpus(mb << 20, seed + 3).encode()
    rs = ResidentStream(ranks, {}, LLAMA4_PATTERN, window=window,
                        batch=batch, device=dev)
    print(f"stand-in vocab {len(ranks)} ranks, corpus {len(text)} B, "
          f"vhash8 {rs.tables.vhash8_rows.numel() * 4} B "
          f"({rs.tables.vhash8_dropped} dropped), set-up "
          f"{time.perf_counter() - t:.1f} s")
    rs.encode(text[: window * batch])  # warm-up: allocator and libraries
    kernels = (BP.piece_starts_bits, CP.compact_piece_keys,
               CP.compact_by_mask)
    for k in kernels:
        k.launches = 0
    out, st = rs.encode(text)
    launches = [k.launches for k in kernels]
    print(f"stream: {st.n_windows} windows, {st.n_batches} batches, "
          f"wall {st.wall_s:.4f} s = {st.wall_mbps:.1f} MB/s, spliced "
          f"{st.spliced_pieces} pieces, host fallback "
          f"{st.host_fallback_windows}, launches {launches}")
    print("stream wall split (host clock, s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in st.extra.items()))
    if st.host_fallback_windows:
        raise AssertionError("a window fell back to the host engine")
    if any(n != st.n_batches for n in launches):
        raise AssertionError(f"launches {launches} != {st.n_batches} batches")
    wins = stream_windows(text, window)
    t = time.perf_counter()
    for i in range(min(batch, len(wins))):
        want = rs.host.encode_ordinary(wins[i].tobytes().decode("ascii"))
        if out[i] != want:
            j = next(j for j, (a, b) in enumerate(zip(out[i], want)) if a != b)
            raise AssertionError(f"window {i} differs from the host engine "
                                 f"at id {j}")
    print(f"first {min(batch, len(wins))} windows equal the host engine "
          f"({time.perf_counter() - t:.1f} s)")
    if dev != "cpu":
        stage_times(rs, wins[:batch])
        idle_share(lambda: rs.encode(text), f"stream encode of {len(text)} B")
    return dict(zip(("piece_starts", "compact_piece_keys", "compact_by_mask"),
                    launches))


def stage_times(rs, wins) -> None:
    """Per-stage device times of one batch (CUDA events)."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops.join import vocab_probe8

    d = torch.zeros((rs.batch, rs.window), dtype=torch.uint8)
    nb = torch.zeros((rs.batch,), dtype=torch.int32)
    for r, w in enumerate(wins):
        d[r, : len(w)] = torch.from_numpy(np.array(w))
        nb[r] = len(w)
    d, nb = d.cuda(), nb.cuda()
    st = BP.piece_starts_bits(d, nb, profile=rs.profile)
    keys = CP.compact_piece_keys(st, d, nb, rs.p_cap, packed=True)
    rank = vocab_probe8(*keys[2:6], keys[1], rs.tables.vhash8_rows,
                        rs.tables.vhash8_mask)
    t = dict(
        starts=median_ms(lambda: BP.piece_starts_bits(d, nb,
                                                      profile=rs.profile)),
        compact=median_ms(lambda: CP.compact_piece_keys(st, d, nb, rs.p_cap,
                                                        packed=True)),
        probe=median_ms(lambda: vocab_probe8(
            *keys[2:6], keys[1], rs.tables.vhash8_rows,
            rs.tables.vhash8_mask)),
        finalize=median_ms(lambda: CP.finalize(keys[0], keys[1], rank,
                                               keys[6], p_cap=rs.p_cap)),
        pipeline=median_ms(lambda: rs.pipeline(d, nb)),
    )
    print("stage ms (one batch of 8 x 1 MB): " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items()))


def idle_share(fn, what: str) -> None:
    """Runs ``fn`` once untraced and once under ``profile_trace``; prints
    both walls, the device's busy time in the trace (the union of its
    kernels and copies) and the device's idle share of the traced wall."""
    import tempfile

    from tokendagger_tpu_torch.utils.profiling import (
        device_busy_us, profile_trace,
    )

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t) * 1e3
    with tempfile.TemporaryDirectory() as d:
        with profile_trace(d):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        busy_us, n = device_busy_us(d)
    if not n:
        print(f"{what}: idle share not measured (the trace holds no "
              f"kernels); wall {untraced_ms:.3f} ms untraced, "
              f"{wall_ms:.3f} ms traced")
        return
    print(f"{what}: device busy {busy_us / 1e3:.3f} ms of {wall_ms:.3f} ms "
          f"traced wall ({n} kernels), idle share "
          f"{1 - busy_us / 1e3 / wall_ms:.4f}; wall {untraced_ms:.3f} ms "
          "untraced")


def engine_counters():
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import pretokenize as PT

    return dict(utf8_decode_block=PT.utf8_decode_block,
                piece_starts_cp=BP.piece_starts_chars,
                compact_piece_keys=CP.compact_piece_keys,
                compact_by_mask=CP.compact_by_mask)


def first_diff(a: list, b: list) -> int:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def run_engine(seed: int, mb: int, dev, *,
               n_ranks=200_000) -> tuple[dict, dict, dict]:
    """Tokenizer(backend="device") over >= mb MB of multi-script text with
    specials; returns the engine kernels' launch counts, their largest
    errors against the plain versions on the engine's windows, and K4's
    timings at the engine's shapes."""
    from tokendagger_tpu_torch import (
        LLAMA4_PATTERN, EngineStats, HostEngine, Tokenizer,
    )

    t = time.perf_counter()
    ranks = standin_vocab(n_ranks, seed, extra=multiscript(1 << 20,
                                                          seed + 4))
    specials = {s: n_ranks + i for i, s in enumerate(SPECIALS)}
    plain_text = multiscript(mb << 20, seed + 5)
    text = with_specials(plain_text, seed + 6, start=2 * len(plain_text) // 3)
    nbytes = len(text.encode())
    tok = Tokenizer("standin", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, device=dev)
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    tok.encode(text[: 1 << 20], allowed_special="all")  # warm-up
    eng = tok._get_device()
    print(f"engine: stand-in vocab {len(ranks)} ranks + {len(specials)} "
          f"specials, text {nbytes} B, set-up {time.perf_counter() - t:.1f} s")

    counters = engine_counters()
    for k in counters.values():
        k.launches = 0
    eng.stats = EngineStats()
    t = time.perf_counter()
    ids = tok.encode(text, allowed_special="all")
    wall = time.perf_counter() - t
    launches = {n: k.launches for n, k in counters.items()}
    st = eng.stats
    other = wall - st.safe_cut_s - st.device_s - st.drain_s - st.host_s
    print(f"engine encode: {nbytes} B in {wall:.4f} s = "
          f"{nbytes / 1e6 / wall:.1f} MB/s wall; {st.windows} windows, "
          f"{st.cut_windows} cut at a safe offset, {st.grown_windows} grown, "
          f"{st.host_advance_windows} host-advance, "
          f"{st.spliced_pieces} spliced pieces, {len(ids)} ids")
    print(f"engine wall split (host clock, s): safe_cut {st.safe_cut_s:.4f}, "
          f"device {st.device_s:.4f}, drain {st.drain_s:.4f}, host_advance "
          f"{st.host_s:.4f}, specials/lists {other:.4f}")
    print("engine launches: " + ", ".join(
        f"{n} {v} ({v / max(st.windows, 1):.2f}/window)"
        for n, v in launches.items()))
    if dev != "cpu" and any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the engine path never ran: "
                             f"{launches}")
    if dev != "cpu" and st.cut_windows < 2:
        raise AssertionError("the 4 MB windows were not cut at safe offsets")

    t = time.perf_counter()
    want = host.encode(text, set(specials))[0]
    if ids != want:
        raise AssertionError(f"engine ids differ from the host engine at "
                             f"id {first_diff(ids, want)}")
    print(f"engine ids equal the host engine ({len(ids)} ids, host "
          f"{time.perf_counter() - t:.1f} s)")
    if dev != "cpu":
        idle_share(lambda: tok.encode(text, allowed_special="all"),
                   f"engine encode of {nbytes} B")

    rng = np.random.default_rng(seed + 7)
    cuts = np.sort(rng.integers(0, len(text), 128)).tolist()
    texts = [text[a : a + (b - a) // int(rng.integers(1, 40))]
             for a, b in zip(cuts[0::2], cuts[1::2])]
    texts[0], texts[1] = "", text[: 5 << 20]
    got = tok.encode_batch(texts, allowed_special="all")
    for i, tx in enumerate(texts):
        w = host.encode(tx, set(specials))[0]
        if got[i] != w:
            raise AssertionError(f"encode_batch text {i} differs at id "
                                 f"{first_diff(got[i], w)}")
    print(f"engine encode_batch: {len(texts)} texts "
          f"({sum(len(x.encode()) for x in texts)} B) equal the host engine")

    t = time.perf_counter()
    back = tok.decode(ids)
    dt = time.perf_counter() - t
    if back != text:
        raise AssertionError("decode(encode(text)) != text")
    print(f"engine decode round trip: equal ({dt:.4f} s, device decode)")

    # an ordinary text with a 5 MB digit run (one class run: windows
    # grow to 16 MB) a quarter of the way in
    rng = np.random.default_rng(seed + 8)
    digits = (rng.integers(0, 10, 5 << 20) + 48).astype(np.uint8)
    at = len(plain_text) // 4
    grown_text = (plain_text[:at] + " " + digits.tobytes().decode() + " "
                  + plain_text[at:])
    window_choice(eng, host, grown_text)
    errs, times = {}, {}
    if dev != "cpu":
        run_at = len(plain_text[:at].encode()) + 1
        errs, times = engine_windows(eng, [
            ("4 MB", text.encode()[:ENGINE_WINDOW], ENGINE_WINDOW),
            ("16 MB grown", grown_text.encode()[run_at:run_at + MAX_WINDOW],
             MAX_WINDOW)], dev)
    return launches, errs, times


def engine_windows(eng, windows, dev) -> tuple[dict, dict]:
    """Every kernel of the engine's window pipeline against its plain
    version, stage by stage as ``DeviceEngine.window_pipeline`` runs them,
    on (label, window bytes, scan size) windows, each cut at its safe
    offset; then the per-stage times of the first (CUDA events around
    synchronized calls) and K4's times at its three shapes there (the
    decode's compaction and finalize_host's two). Returns the largest
    error of each kernel, and K4's timings by shape."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import pretokenize as PT
    from tokendagger_tpu_torch.ops.fused import caps_for, finalize_host
    from tokendagger_tpu_torch.ops.join import vocab_probe8

    errs = dict.fromkeys(("utf8_decode_block", "piece_starts_cp",
                          "compact_piece_keys", "compact_by_mask"), 0)
    k4_times: dict = {}
    prof = eng._profile
    rows, mask = eng.tables.vhash8_rows, eng.tables.vhash8_mask
    for label, raw, N in windows:
        n = len(raw)
        buf = np.zeros((1, N), np.uint8)
        buf[0, :n] = np.frombuffer(raw, np.uint8)
        d = torch.from_numpy(buf).to(dev)
        nb = torch.tensor([n], dtype=torch.int32, device=dev)
        trim = eng._safe_cut_threshold(raw)
        p_cap = caps_for(N)["p_cap"]
        e = {}
        cp_at, lead = PT.utf8_decode_block(d)
        e["utf8_decode_block"] = max_abs_err(
            (cp_at, lead), PT.utf8_decode_block_plain(d))
        # K4 as utf8_decode calls it: codepoints and byte offsets of leads
        idx = torch.arange(N, dtype=torch.int32, device=dev)
        is_lead = (lead != 0) & (idx < nb[:, None])
        arrs = [cp_at, idx.expand(1, N).contiguous()]
        k4 = [max_abs_err(CP.compact_by_mask(arrs, is_lead, fill=0),
                          CP.compact_by_mask_plain(arrs, is_lead, fill=0))]
        cp, cob, _, m = PT.utf8_decode(d, nb)
        words = BP.piece_starts_chars(cp, m, profile=prof, packed_out=True)
        e["piece_starts_cp"] = max_abs_err(
            [words], [BP.piece_starts_chars_plain(cp, m, profile=prof)])
        st = BP.unpack_mask(words)
        stb = PT.starts_to_bytes(st, cob, d, nb)
        keys = CP.compact_piece_keys(stb, d, nb, p_cap)
        e["compact_piece_keys"] = max_abs_err(
            keys, CP.compact_piece_keys_plain(stb, d, nb, p_cap))
        rank = vocab_probe8(*keys[2:6], keys[1], rows, mask)
        # K4 in finalize: the same function on the CPU runs K4's plain
        # version, and every output but the sums is K4's
        fin_args = (keys[0], keys[1], rank, keys[6])
        with recorded_inputs() as fin_k4:
            got = finalize_host(*fin_args, trim, p_cap=p_cap)
        want = finalize_host(*(a.cpu() for a in fin_args), trim, p_cap=p_cap)
        k4.append(max_abs_err([g.cpu() for g in got], list(want)))
        e["compact_by_mask"] = max(k4)
        npc, consumed = int(keys[6]), int(got[4])
        print(f"engine window {label} ({n} B, trim {trim}, consumed "
              f"{consumed}, {npc} pieces, p_cap {p_cap}): max_abs_err "
              + ", ".join(f"{k} {v}" for k, v in e.items()))
        if any(e.values()):
            raise AssertionError(f"engine window {label}: a kernel differs "
                                 f"from its plain version: {e}")
        if not 0 < consumed <= trim < n:
            raise AssertionError(f"engine window {label} was not cut at a "
                                 "safe offset")
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        if label != windows[0][0] or dev == "cpu":
            continue
        t = dict(
            utf8_decode=median_ms(lambda: PT.utf8_decode(d, nb)),
            piece_starts=median_ms(lambda: BP.piece_starts_chars(
                cp, m, profile=prof)),
            starts_to_bytes=median_ms(
                lambda: PT.starts_to_bytes(st, cob, d, nb)),
            compact=median_ms(
                lambda: CP.compact_piece_keys(stb, d, nb, p_cap)),
            probe=median_ms(lambda: vocab_probe8(*keys[2:6], keys[1], rows,
                                                 mask)),
            finalize=median_ms(lambda: finalize_host(
                keys[0], keys[1], rank, keys[6], trim, p_cap=p_cap)),
            pipeline=median_ms(lambda: eng.window_pipeline(d, nb, trim)),
        )
        print(f"engine stage ms (one {label} window, {npc} pieces, p_cap "
              f"{p_cap}): " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
        shapes = [(f"engine decode (1, {N}) k 2", (arrs, is_lead, 0))]
        shapes += [(f"engine finalize (1, {p_cap}) k {len(a[0])} fill {a[2]}",
                    a) for key, a in fin_k4.items()
                   if key[0] == "compact_by_mask"]
        for at, (arrays, mm, fill) in shapes:
            k, kept, P = len(arrays), int(mm.sum()), mm.numel()
            k4_times[at] = timings(
                lambda: CP.compact_by_mask(arrays, mm, fill=fill),
                lambda: CP.compact_by_mask_plain(arrays, mm, fill=fill),
                P + 4 * k * kept + 4 * k * P, P)
            print(f"K4 compact_by_mask [{at}, {kept} kept]: "
                  f"{show(k4_times[at])}")
    return errs, k4_times


def window_choice(eng, host, text: str) -> None:
    """Ordinary encode of ``text`` with 4 MB and 1 MB starting windows, in
    turns (4, 1, 1, 4) on the same engine; every run's ids must equal the
    host engine's, and the 4 MB runs must cut and grow windows."""
    from tokendagger_tpu_torch import EngineStats

    data = text.encode()
    rates = {1 << 22: [], 1 << 20: []}
    t = time.perf_counter()
    want = host.encode_ordinary(text)
    host_s = time.perf_counter() - t
    for w in (1 << 22, 1 << 20, 1 << 20, 1 << 22):
        eng._window, eng.stats = w, EngineStats()
        t = time.perf_counter()
        ids = eng.encode_stream(data)
        rates[w].append(len(data) / 1e6 / (time.perf_counter() - t))
        st = eng.stats
        if ids.tolist() != want:
            raise AssertionError(
                f"{w >> 20} MB windows differ from the host engine at id "
                f"{first_diff(ids.tolist(), want)}")
    eng._window = ENGINE_WINDOW
    print(f"engine ordinary encode ({len(data)} B with a 5 MB digit run; "
          f"last run, 4 MB windows): {st.windows} windows, {st.cut_windows} "
          f"cut at a safe offset, {st.grown_windows} grown, "
          f"{st.host_advance_windows} host-advance; ids equal the host "
          f"engine ({len(want)} ids, host {host_s:.1f} s)")
    if st.cut_windows < 1 or st.grown_windows < 1:
        raise AssertionError("the ordinary encode did not cut and grow "
                             "windows")
    print("engine window choice (ordinary encode, wall MB/s, two runs "
          "each): " + ", ".join(
              f"{w >> 20} MB {' / '.join(f'{r:.1f}' for r in rs)}"
              for w, rs in rates.items()))


RESIDENT_KERNELS = ("utf8_decode_block", "piece_starts_cp",
                    "piece_starts_words", "compact_piece_keys",
                    "compact_by_mask", "compact_record", "expand_route")


def resident_counters():
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import pretokenize as PT

    return dict(utf8_decode_block=PT.utf8_decode_block,
                piece_starts_cp=BP.piece_starts_chars,
                piece_starts_words=BP.piece_starts_words,
                compact_piece_keys=CP.compact_piece_keys,
                compact_by_mask=CP.compact_by_mask,
                compact_record=CP.compact_record,
                expand_route=CP.expand_route)


# each kernel's launcher, by module: the one place its wrapper launches it
LAUNCHERS = (("utf8_decode_block", "pretokenize", "_launch_k9"),
             ("piece_starts_cp", "bitplane", "_launch_k1_cp"),
             ("piece_starts_words", "bitplane", "_launch_k1_words"),
             ("compact_piece_keys", "compact", "_launch_k2k3"),
             ("compact_by_mask", "compact", "_launch_k4"),
             ("compact_record", "compact", "_launch_k5k6"),
             ("expand_route", "compact", "_launch_k7k8"))


def _arg_key(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    if isinstance(x, list):
        return (len(x), tuple(x[0].shape))
    return x


def _arg_copy(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, list):
        return [a.clone() for a in x]
    return x


@contextlib.contextmanager
def recorded_inputs():
    """Keeps copies of the arguments of each kernel's first launch at each
    shape the main path gives it, keyed (kernel, shapes and scalars of
    the arguments); the run's untimed warm-up makes those first
    launches."""
    import importlib

    seen: dict = {}
    saved = []
    for name, mod, fn in LAUNCHERS:
        m = importlib.import_module(f"tokendagger_tpu_torch.ops.{mod}")
        orig = getattr(m, fn)

        def spy(*args, _name=name, _orig=orig):
            key = (_name, *map(_arg_key, args))
            if key not in seen:
                seen[key] = [_arg_copy(a) for a in args]
            return _orig(*args)

        saved.append((m, fn, orig))
        setattr(m, fn, spy)
    try:
        yield seen
    finally:
        for m, fn, orig in saved:
            setattr(m, fn, orig)


def run_resident_phase(seed: int, dev, *, reps: int = 20,
                       n_ranks=200_000) -> tuple[dict, dict]:
    """run_resident at 8 x 1 MB of multi-script text, explicit capacity
    3.0 then auto; returns each kernel's launches over both runs and, by
    run, the arguments of each kernel's first launch at each shape."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, run_resident

    t = time.perf_counter()
    ranks = standin_vocab(n_ranks, seed, extra=multiscript(1 << 20,
                                                          seed + 4))
    corpus = multiscript(9 * WINDOW, seed + 9).encode()
    print(f"resident: stand-in vocab {len(ranks)} ranks, corpus "
          f"{len(corpus)} B, set-up {time.perf_counter() - t:.1f} s")
    counters = resident_counters()
    launches = dict.fromkeys(counters, 0)
    inputs: dict = {}
    for cap in (3.0, 0):
        for k in counters.values():
            k.launches = 0
        label = "cap 3.0" if cap else "auto cap"
        t = time.perf_counter()
        with recorded_inputs() as inputs[label]:
            r = run_resident(ranks, {}, LLAMA4_PATTERN, corpus,
                             window=WINDOW, n_windows=BATCH, batch=BATCH,
                             reps=reps, cap_bytes_per_piece=cap,
                             probe_impl="chunks", device=dev)
        run = {n: k.launches for n, k in counters.items()}
        print(f"resident {label}: impl {r.impl}, match_host {r.match_host}, "
              f"overflow_windows {r.overflow_windows}, cap_bpp {r.cap_bpp}, "
              f"probe_impl {r.probe_impl}, probe_hot {r.probe_hot}, "
              f"total_tokens {r.total_tokens}, {time.perf_counter() - t:.1f} s")
        print(f"resident {label}: kernel_mbps {r.kernel_mbps}, device_ms "
              f"{r.device_ms}, wall_mbps {r.wall_mbps} (wall_ms {r.wall_ms}, "
              f"calibration_ms {r.calibration_ms}), stage_us "
              f"{json.dumps(r.stage_us)}")
        print(f"resident {label}: overlap {json.dumps(r.overlap)}")
        print(f"resident {label}: launches {json.dumps(run)}")
        if not (r.match_host and r.overflow_windows == 0
                and r.impl == "general"):
            raise AssertionError(f"resident {label}: ids differ from the "
                                 "host engine, or a window overflowed")
        # K1 runs once per pipeline run: its entry counts the runs
        runs = run["piece_starts_words"] + run["piece_starts_cp"]
        per = 1 if cap else 3
        if run["compact_record"] != per * runs or run[
                "expand_route"] != per * runs:
            raise AssertionError(f"resident {label}: K5+K6/K7+K8 launched "
                                 f"{run} times in {runs} pipeline runs")
        if cap == 0 and (r.probe_impl != "hot"
                         or run["piece_starts_words"] != runs):
            raise AssertionError("resident auto cap: a hot route is off")
        for n, v in run.items():
            launches[n] += v
    dead = [n for n, v in launches.items() if v == 0]
    if dead:
        raise AssertionError(f"resident: kernels never launched: {dead}")
    return launches, inputs


def edge_masks(mask: torch.Tensor) -> torch.Tensor:
    """``mask`` with row 0 empty, row 1 all kept and row 2 skewed (its
    first half empty, its second half dense)."""
    m = mask.clone()
    N = m.shape[1]
    m[0] = False
    m[1] = True
    if m.shape[0] > 2:
        m[2, : N // 2] = False
        m[2, N // 2 :] = torch.arange(N - N // 2, device=m.device) % 8 != 0
    return m


def check_resident_kernels(inputs: dict, dev) -> list[dict]:
    """K5+K6, K7+K8 and K1's class-word entry against their plain versions
    on the inputs the auto run gave them (``inputs``, as
    ``recorded_inputs`` keeps them), and on edge rows at the same shapes;
    times at each shape."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP

    # in the order the pipeline launches them: decode, classes, probe
    k5 = [k for k in inputs if k[0] == "compact_record"]
    k7 = [k for k in inputs if k[0] == "expand_route"]
    k1 = [k for k in inputs if k[0] == "piece_starts_words"]
    if len(k5) != 3 or len(k7) != 3 or len(k1) != 1:
        raise AssertionError(f"expected three route shapes and one K1 word "
                             f"shape, got {sorted(inputs)}")
    names = ("decode", "classes", "probe")
    rows = {}
    err5 = err7 = 0
    t5, t7 = {}, {}
    for name, key5 in zip(names, k5):
        arrays, mask, cap, fill = inputs[key5]
        key7 = next(k for k in k7 if k[3] == tuple(mask.shape)
                    and k[1][1] == cap)
        B, N = mask.shape
        e5 = e7 = 0
        for m in (mask, edge_masks(mask)):
            got = CP.compact_record(arrays, m, cap=cap, fill=fill)
            want = CP.compact_record_plain(arrays, m, cap=cap, fill=fill)
            e5 = max(e5, max_abs_err([*got[0], got[1], got[2]],
                                     [*want[0], want[1], want[2]]))
            dense = inputs[key7][0] if m is mask else got[0][0]
            route = got[2]
            back = CP.expand_route(dense, route, m)
            e7 = max(e7, max_abs_err(
                [back], [CP.expand_route_plain(dense, route, m)]))
        print(f"K5+K6 compact_record [{name}: {len(arrays)} x {(B, N)} -> "
              f"cap {cap}]: max_abs_err {e5}; K7+K8 expand_route: "
              f"max_abs_err {e7} (main-path inputs and edge rows)")
        if e5 or e7:
            raise AssertionError(f"K5-K8 differ from their plain versions "
                                 f"at the {name} shape")
        err5, err7 = max(err5, e5), max(err7, e7)
        # timing on the main path's inputs
        got = CP.compact_record(arrays, mask, cap=cap, fill=fill)
        kept = int(torch.clamp(got[1], max=cap).sum())
        n_set = int(mask.sum())
        stack = torch.stack(arrays)
        src = torch.masked_select(arrays[0], mask)
        out = torch.zeros((B, N), dtype=torch.int32, device=dev)
        dense, route = inputs[key7][0], got[2]
        fetched = int((mask & (route < cap)).sum())
        t5[name] = timings(
            lambda: CP.compact_record(arrays, mask, cap=cap, fill=fill),
            lambda: CP.compact_record_plain(arrays, mask, cap=cap,
                                            fill=fill),
            B * N + 4 * len(arrays) * kept + 4 * len(arrays) * B * cap
            + 4 * B * N + 4 * B, B * N)
        t5[name].update(library(lambda: torch.masked_select(stack, mask),
                                "masked_select (no route)"))
        t7[name] = timings(
            lambda: CP.expand_route(dense, route, mask),
            lambda: CP.expand_route_plain(dense, route, mask),
            4 * B * N + B * N + 4 * fetched + 4 * B * N, B * N)
        t7[name].update(library(lambda: out.masked_scatter_(mask, src),
                                "masked_scatter_"))
        for lab, t in (("K5+K6", t5[name]), ("K7+K8", t7[name])):
            print(f"{lab} [{name}, {n_set} of {B * N} set]: {show(t)}")
    for nm, src_, err, t in (
            ("compact_record", "tokendagger_tpu/ops/compact_pallas.py:434 "
             "(compact_tiles_masked) + :624 (degap_record)", err5, t5),
            ("expand_route", "tokendagger_tpu/ops/compact_pallas.py:670 "
             "(regap_replay) + :728 (expand_tiles_replay)", err7, t7)):
        rows[nm] = dict(
            name=nm, route="cuda", source="tokendagger_tpu_torch/csrc/route.cu",
            replaces=src_, max_abs_err=err, **t["decode"], **by_shape(t),
            library_ms_by_shape={k: v["library_ms"] for k, v in t.items()})

    # ---- K1's class-word entry: the auto run's class words ----
    words, m, _ = inputs[k1[0]]
    werr = 0
    short = m.clone()
    short[0] = 12345          # a ragged length inside the first segment
    short[1] = 0              # an empty window
    for prof in ("llama4", "nocontract", "cl100k", "gpt2"):
        err = 0
        for mm in (m, short):
            got = BP.piece_starts_words(words, mm, profile=prof)
            want = BP.piece_starts_words_plain(words, mm, profile=prof)
            err = max(err, max_abs_err([got], [want]))
        print(f"K1 piece_starts_words[{prof}] {tuple(words.shape)}: "
              f"max_abs_err {err}")
        if err:
            raise AssertionError(f"K1 class-word entry {prof} differs")
        werr = max(werr, err)
    B, C = words.shape
    passes = BP.starts_passes("llama4", C)
    spw = k1_blocks("words", B, C)
    t = timings(lambda: BP.piece_starts_words(words, m),
                lambda: BP.piece_starts_words_plain(words, m),
                4 * B * C + B * C / 8 + 4 * B, passes * B * C / 32,
                plain_reps=3)
    print(f"K1 piece_starts_words {(B, C)}: {show(t)}; {passes} passes, "
          f"{spw} blocks per window")
    rows["piece_starts_words"] = dict(
        name="piece_starts_words", route="cuda",
        source="tokendagger_tpu_torch/csrc/piece_starts.cu",
        replaces="tokendagger_tpu/ops/bitplane.py:1152", max_abs_err=werr,
        **t, library_ms=None, passes=passes, blocks_per_window=spw)
    return [rows["compact_record"], rows["expand_route"],
            rows["piece_starts_words"]]


SHARED_KERNELS = ("utf8_decode_block", "piece_starts_cp",
                  "compact_piece_keys", "compact_by_mask")


def check_resident_shared(runs: dict, seed: int, dev) -> tuple[dict, dict]:
    """The kernels the resident path shares with the other paths (K9, K1's
    codepoint entry, K2+K3, K4) against their plain versions on the
    inputs each resident run gave them (``runs``: label -> the run's
    ``recorded_inputs``), and on edge rows at the same shapes: random
    bytes for K9, a ragged char count for K1 (all four profiles), an
    empty window for K2+K3, an all-missed row for K4. Returns each
    kernel's largest error, and its timings by shape."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import pretokenize as PT

    todo: dict = {}
    for label, seen in runs.items():
        for key, args in seen.items():
            if key[0] in SHARED_KERNELS:
                todo.setdefault(key, (label, args))
    errs = dict.fromkeys(SHARED_KERNELS, 0)
    times: dict = {k: {} for k in SHARED_KERNELS}
    g = torch.Generator(device=dev).manual_seed(seed)
    for key, (label, args) in todo.items():
        name = key[0]
        if name == "utf8_decode_block":
            (d,) = args
            B, N = shape = d.shape
            edge = d.clone()
            edge[0] = torch.randint(0, 256, (N,), generator=g, device=dev,
                                    dtype=torch.uint8)
            err = max(max_abs_err(PT.utf8_decode_block(x),
                                  PT.utf8_decode_block_plain(x))
                      for x in (d, edge))
            t = timings(lambda: PT.utf8_decode_block(d),
                        lambda: PT.utf8_decode_block_plain(d),
                        9 * B * N, 20 * B * N)
        elif name == "piece_starts_cp":
            cp, m, _ = args
            B, C = shape = cp.shape
            short = m.clone()
            short[0] = 12345   # a ragged length inside the first segment
            short[1] = 0       # an empty window
            err = 0
            for prof in ("llama4", "nocontract", "cl100k", "gpt2"):
                e = max(max_abs_err(
                    [BP.piece_starts_chars(cp, mm, profile=prof,
                                           packed_out=True)],
                    [BP.piece_starts_chars_plain(cp, mm, profile=prof)])
                    for mm in (m, short))
                print(f"K1 piece_starts_cp[{prof}] {(B, C)}: max_abs_err {e}")
                err = max(err, e)
            passes = BP.starts_passes("llama4", C)
            t = timings(lambda: BP.piece_starts_chars(cp, m, packed_out=True),
                        lambda: BP.piece_starts_chars_plain(cp, m),
                        4 * B * C + B * C / 8 + 4 * B, passes * B * C / 32,
                        plain_reps=3)
            t["blocks_per_window"] = k1_blocks("codepoints", B, C)
        elif name == "compact_piece_keys":
            starts, d, nb, p_cap, packed = args
            B, N = d.shape
            shape = (B, N, p_cap)
            empty = nb.clone()
            empty[0] = 0
            err = max(max_abs_err(
                CP.compact_piece_keys(starts, d, n, p_cap, packed=packed),
                CP.compact_piece_keys_plain(starts, d, n, p_cap,
                                            packed=packed))
                for n in (nb, empty))
            got = CP.compact_piece_keys(starts, d, nb, p_cap, packed=packed)
            key_bytes = int(torch.clamp(got[1], max=16).sum())
            flag_bytes = B * N / 8 if packed else B * N
            t = timings(lambda: CP.compact_piece_keys(starts, d, nb, p_cap,
                                                      packed=packed),
                        lambda: CP.compact_piece_keys_plain(
                            starts, d, nb, p_cap, packed=packed),
                        flag_bytes + key_bytes + 8 * B + 24 * B * p_cap,
                        B * N)
        else:                                       # compact_by_mask
            arrays, mask, fill = args
            B, P = shape = mask.shape
            edge = mask.clone()
            edge[0] = True     # an all-kept row
            edge[1] = False    # an empty row
            err = max(max_abs_err(CP.compact_by_mask(arrays, mm, fill=fill),
                                  CP.compact_by_mask_plain(arrays, mm,
                                                           fill=fill))
                      for mm in (mask, edge))
            kept = int(mask.sum())
            k = len(arrays)
            t = timings(lambda: CP.compact_by_mask(arrays, mask, fill=fill),
                        lambda: CP.compact_by_mask_plain(arrays, mask,
                                                         fill=fill),
                        B * P + 4 * k * kept + 4 * k * B * P, B * P)
        at = f"resident {label} {tuple(shape)}"
        print(f"{name} [{at}]: max_abs_err {err} (main-path inputs and "
              f"edge rows); {show(t)}")
        if err:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{at}")
        errs[name] = max(errs[name], err)
        times[name][at] = t
    missing = [k for k in SHARED_KERNELS if not times[k]]
    if missing:
        raise AssertionError(f"resident: no recorded inputs for {missing}")
    return errs, times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--engine-mb", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    from tokendagger_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t = time.perf_counter()
    libs = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    rows = check_kernels(args.seed, "cuda") + check_engine_kernels(
        args.seed, "cuda")
    # each path runs with the counts set to 0 just before it; a kernel on
    # several paths reports the sum of its launches as "launches", and
    # each path's count in "launches_by_path"
    stream = run_stream(args.seed, args.mb, "cuda")
    engine, engine_errs, engine_times = run_engine(args.seed,
                                                   args.engine_mb, "cuda")
    resident, inputs = run_resident_phase(args.seed, "cuda")
    rows += check_resident_kernels(inputs["auto cap"], "cuda")
    resident_errs, resident_times = check_resident_shared(inputs, args.seed,
                                                          "cuda")
    for r in rows:
        name = r["name"]
        by_path = dict(stream=stream.get(name, 0),
                       engine=engine.get(name, 0),
                       resident=resident.get(name, 0))
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        r["max_abs_err"] = max(r["max_abs_err"], engine_errs.get(name, 0),
                               resident_errs.get(name, 0))
        more = {**resident_times.get(name, {}),
                **(engine_times if name == "compact_by_mask" else {})}
        for k, v in by_shape(more).items():
            r.setdefault(k, {}).update(v)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_call_ms",
            "library", "passes", "blocks_per_window", "ms_by_shape",
            "call_ms_by_shape", "plain_ms_by_shape", "bound_ms_by_shape",
            "library_ms_by_shape", "blocks_per_window_by_shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
