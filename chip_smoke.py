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
   torch.profiler trace, since it synchronizes on the host; a trace that
   holds no kernel event is taken again, up to three times, and the run
   fails if none holds one. K4 must run one kernel per call, and K2+K3
   one per call at each of its shapes (launch calls in a trace); K1 must
   spread each window over many blocks. K2+K3 is also timed on an edge
   row: seven empty windows and one window that is one piece, packed and
   byte flags.
   Then the whole-piece probe kernel (``csrc/probe.cu``) against its
   plain version on the stand-in's vhash8 table (the engine phase's
   200,000 ranks, 2^18 buckets) with those windows' keys and with edge
   rows (a dead row, a row of length -1, a row of hits in full buckets),
   timed beside its bytes bound (keys, output and each table row the
   pieces touch, once) and ``rows.index_select(0, h)`` alone, the gather
   any torch formulation pays (device time by trace, and call time).
   Then K1's byte entry on 300 windows of 1 KB, more than the card holds
   its blocks (so they run in groups), against its plain version.
3. Holds the kernels of the public API's engine against their plain
   versions at the engine's shapes: the UTF-8 decode (K9) on 4 MB and
   16 MB windows of seeded multi-script text and invalid UTF-8, and K1's
   codepoint entry on 4 MB and 16 MB multi-script windows (with an empty
   window and a ragged length inside the first segment) for all five
   profiles; under kimi also on Han-heavy windows at the engine's 1 MB
   and 4 MB shapes (with an empty window and a ragged length), timed
   beside llama4 on the same window.
   After step 5's run, every kernel of the engine's window pipeline (K9,
   K4 in the decode's compaction, K1, K2+K3, the probe, K4 in finalize)
   is held
   against its plain version stage by stage on one 4 MB window and on
   one grown 16 MB window of that run's texts, and K2+K3 (on the 4 MB
   window's byte flags), the probe and K4 (at the decode's and
   finalize_host's shapes) are timed there.
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
6. (Run before steps 4 and 5, so that its kernels' library yardsticks
   are traced before those long phases.) Drives run_resident, the
   batched general pipeline, on the card at
   full width: 8 windows of 1 MB of seeded multi-script text with the
   engine's stand-in vocabulary, once with the explicit capacity 3.0 and
   once with the auto capacity (both hot routes: hot codepoints and hot
   pieces). Each run's ids must equal the host engine's with no overflow,
   and every kernel of the path must have launched. Prints each run's
   kernel_mbps, device_ms, wall_mbps and overlap dict, and its device
   stage times (kernel, copy and memset durations summed per stage from
   run_resident's profiler trace) beside its CUDA-event stage times,
   with the trace's kernel events against the wrappers' launches: a
   trace that lost a kernel event fails the run (here and in every
   run_resident call below). Then
   holds K5+K6 (compact_record), K7+K8 (expand_route) and K1's class-word
   entry (all five profiles) against their plain versions on the inputs
   the auto run gave them at each of the path's shapes (the decode, the
   hot-codepoint classes, the hot-piece probe), and on the same shapes
   with an empty row, an all-kept (overflowing) row and a skewed row
   (K5+K6 must run one kernel per call).
   Then run_resident(batch=1) at 8 windows of 1 MB, one a repetition,
   cycled 20 times ("single": auto on multi-script text and on ASCII,
   impl="scatter", miss_mode="device" with the probe and the sort
   joins), each window then alone, and the batched formulations at
   8 x 1 MB ("formulations": impl sort and scatter x starts_impl jnp and
   bits, compact_impl sort): ids equal to the host engine's, no window
   overflowed, every kernel of each run launched. K9, K1's codepoint
   entry (all five profiles), K2+K3, K4, the merge and the probe are then
   held against their plain versions on the inputs every resident, single
   and formulation run gave them (each distinct input once), with edge
   rows, and timed once at each shape. The char form and match_lengths
   + chain_starts are held against K1's codepoint entry at (8, 1 M) for
   the four profiles it serves (it refuses kimi), and the sort
   formulations are timed beside the
   kernels of the same contract on one 1 MB window. Every kernel's times
   at these shapes join its row of the kernels line (``ms_by_shape``
   and kin, K2+K3's ``library_ms_by_shape`` and
   ``launches_per_call_by_shape`` too).
7. Holds the kernels of the batched grids of short segments
   (``ops/batched.resolve_grid``) against their plain versions at the
   grid shapes (4096, 256), (1024, 1024) and (256, 4096), stage by stage,
   on seeded multi-script rows with an empty row, a row of exactly W
   chars, one piece and all whitespace: K9, K4 in the decode, K1's row
   entry (all five profiles, and kimi again on Han-heavy rows of the same
   lengths; it gets its own row of the kernels line),
   K2+K3 on byte flags with p_cap = W, the probe on the stand-in's table,
   and K4 in finalize_host; times each at each shape.
8. The device BPE merge (``ops/merge.merge_rows``, ``csrc/merge.cu``)
   on the engine phase's stand-in vocabulary, whose pair table's bucket
   count and bytes on the card it prints:
   * the merge kernel against the plain loop on the card at the piece
     path's shapes (8,192 rows of 16, 64 and 256 bytes), at
     resolve_window's 4 MB bucket caps (262,144 x 16, 32,768 x 64,
     4,096 x 256) and at the mesh's (262,144 x 64, 131,072 x 64), with
     and without pair_lut, on seeded random printable rows and edge rows
     (lengths 0, 1 and W, runs of one byte, bytes without ranked pairs);
     then on edge calls: R = 1, one row past a block at each lane count,
     both sides of the lane-count steps, at widths 1-256, on the
     stand-in's tables and on a chain vocabulary whose rows merge W - 1
     times, with lengths 0 and 1 between long rows (each call must count
     one launch); each shape timed as above beside its bytes bound, its
     latency floor (the longest row's merges times one dependent L2
     read, measured by a pointer chase) and the lanes the kernel gives a
     row;
   * the piece path, DeviceEngine(stream=False), over 4.5 MB of
     multi-script text with seeded rare identifiers, with vocab_fastpath
     True and False (every unique multi-byte piece merges on the card) and
     with a copy of the vocabulary without b"\xff" (which takes the piece
     path by default); ids equal to the host engine's; prints the merge
     rows per width, the merge launches and the wall;
   * miss_mode="device" windows of the same text, join_mode "probe" and
     "sort": ids equal to the host engine's, rows in every merge width,
     the oversize pieces spliced; prints rows per width, overflow windows
     and the host-clock stage times.
   A pattern outside the five profiles cannot run on the card (it has no
   ``regex`` module, which HostEngine needs for such a pattern): the CPU
   tests hold that case (tests/test_torch_engine.py, test_torch_wrapper.py).
9. Drives the public API's other paths, each with the counts set to 0
   just before it and read just after (every kernel of the path must
   have launched), with the engine phase's stand-in vocabulary:
   * "batch": Tokenizer(backend="device").encode_batch over 10,008 texts
     (10,000 seeded multi-script texts of log-uniform 16-4,096 B, every
     8th with a special, and 8 of 256 KB). Every text's ids must equal
     the host engine's. Prints the grids by width, the segments by route,
     the wall rate, kernel launches per segment and the device's idle
     share; then the first 1,000 texts through the grids and segment by
     segment through encode_stream, in turns, whose launches per segment
     the grids must undercut;
   * "corpus": CorpusProcessor with 4 threads over 32 seeded files of
     64-512 KB; every shard must equal the host engine's ids and a second
     process must skip every file; prints the wall rate, and beside it
     the rates of 1 thread and of 4 threads again, into fresh outputs;
   * "streaming": StreamingEncoder fed 4 MB of multi-script text with
     specials in seeded chunks of 1 B-64 KB; the ids must equal one
     encode and the host engine's; prints the wall rate;
   * "kimi": Kimi K2's pattern (the kimi profile) on a stand-in that
     holds some Han-heavy text's pieces: 8 MB of Han-heavy text with
     [EOS] every 256 KB and a 5 MB segment, then encode_batch over 400
     short texts; ids equal to the host engine's, no ``regex`` split, K1
     once a window and its row entry once a grid (counted over this
     path's run), Han pieces spliced, no host route.
10. The host backend and "auto" (the paths "host" and "auto"):
   * "host": Tokenizer(backend="host") must run the native C++ engine
     (built by g++ at first use; the run fails on the pure-Python
     fallback) and prints which binding loaded. Over step 5's 12.6 MB
     text with specials (the one-call encode) and the batch path's 10,008
     texts (encode_batch with specials, encode_ordinary_batch) at 1, 4
     and all cores, then encode and decode as routed: every id equal to
     HostEngine's, whose rate is printed beside the native rates;
   * "auto": one text with specials and encode_batch over the batch
     texts at 16 KB to 16 MB, through the native engine and DeviceEngine
     (walls in turns, the best of two each) and through an "auto"
     Tokenizer: prints the dispatch probe, both walls and the crossover,
     checks that auto chose as its constants say (_DEVICE_MIN_BYTES,
     _DEVICE_AUTO_MIN_BYTES, _DEVICE_HEALTHY_MS) and that every id equals
     the host engine's.
11. The "mesh" path, ``tokendagger_tpu_torch/parallel`` (run last), as
   the JAX package's multi-device dry run drives it, at one NCCL rank
   (``get_mesh(1)``), with a merge-reachable stand-in (the engine phase's
   recipe at 450,000 candidates, the tokens the merge of their bytes does
   not make dropped until the audit holds, renumbered densely; its size
   and times printed):
   * ``sharded_encode_step`` and ``sharded_encode_step_2d`` at (1, 1) on
     262,144 rows of 64 B of the engine text's pretokens: every row's
     tokens equal ``byte_pair_encode``, both counters the totals; the
     merge kernel held against its plain loop on those rows and timed;
   * ``ShardedTextEncoder`` (128 KB shards, 16 KB halo) over 16 MB of
     multi-script text: ids equal to the native host engine's, no
     fallback; prints passes, the wall rate, the audit's time and the
     device's idle share; K9, K4 and the merge held against their plain
     versions on the warm-up's recorded inputs (the merge timed);
   * ``mesh_resident_pipeline`` at 8 x 1 MB with the 200,000-rank
     stand-in, impl "ascii" on ASCII windows and impl "general" with both
     hot routes on multi-script windows: every output equal to
     run_resident's ``batch_pipeline`` on the same windows, ids after the
     splice equal to the host engine's, the counters the totals; the
     kernel rate from a trace's device time; every kernel held against
     its plain version on the recorded inputs;
   * two ranks spawned on the one card over gloo with CUDA tensors (the
     vocabulary handed over in a file): the steps on 65,536 rows and the
     sharded text of 4 MB; rows, counters and ids equal one rank's; both
     rates printed.
   Every kernel of the path (K9, K1 bytes and class words, K2+K3, K4,
   K5-K8, the merge, the probe) must launch in the one-rank legs.
12. Prints a "kernels" JSON line, then the card's name and power limit, and
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
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT_OPS_PER_S = 67e12       # H100 SXM 32-bit non-tensor rate (fp32 figure)
WINDOW, BATCH = 1 << 20, 8
ENGINE_WINDOW = 1 << 22     # the engine's card window (engine.CARD_WINDOW)
MAX_WINDOW = 1 << 24        # its largest, grown window (engine.MAX_WINDOW)
# K1's profiles (vocab.classify_pattern); kimi, Kimi K2's, also gets
# Han-heavy windows and rows of its own
PROFILES = ("llama4", "nocontract", "cl100k", "gpt2", "kimi")

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


@functools.lru_cache(maxsize=4)
def han_heavy(seed: int) -> bytes:
    """About 1.4 MB of seeded Han-heavy text, UTF-8: the kimi profile's
    test text (tests/torch_port_util.han_text), Han runs of every kind of
    Han char (letters, marks, numerals, radicals) beside the chars that
    decide where a run starts and what runs into it."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_port_util import han_text

    return han_text(np.random.default_rng(seed), 1 << 19).encode()


def han_bytes(seed: int, n: int) -> bytes:
    """n bytes of ``han_heavy(seed)``, repeated as needed (the last char
    may be cut)."""
    raw = han_heavy(seed)
    return (raw * (n // len(raw) + 1))[:n]


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


def traced(fn, reps: int = 10) -> tuple[float, float, float]:
    """Device time, kernel events and kernel launches of one call of
    ``fn`` from a short torch.profiler trace of ``reps`` calls: the union
    of their kernel, copy and memset intervals, their kernel events and
    their kernel-launch API calls (cudaLaunchKernel and kin), each over
    ``reps``; the device time is None when the trace holds no kernel
    event. For library calls that synchronize on the host
    (``masked_select`` must learn its output size), where events around a
    run of calls would count the host's gaps. Late in this script a trace
    can lose kernel events (0 to 5 of 10 K5+K6 kernels, where a fresh
    process counts 10), so a kernel count is read from the launches."""
    import glob
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
        events = []
        for path in glob.glob(f"{d}/*.pt.trace.json"):
            with open(path) as f:
                events += json.load(f).get("traceEvents", [])
    launches = sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "Launch" in e.get("name", "")
                   and "Kernel" in e.get("name", "") for e in events)
    if not launches:
        raise AssertionError("the profiler trace holds no kernel launch")
    return (busy_us / 1e3 / reps if n else None), n / reps, launches / reps


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


def library(fn, what: str, tries: int = 3) -> dict:
    """A library yardstick: device time from a trace, synchronized call
    time, and what it computes. A trace that holds no kernel event is
    taken again, up to ``tries`` traces; fails if none holds one."""
    for n in range(1, tries + 1):
        ms = traced(fn)[0]
        if ms is not None:
            return dict(library_ms=ms, library_call_ms=median_ms(fn),
                        library=what, library_traces=n)
    raise AssertionError(f"{what}: {tries} traces held no kernel event")


K23_LAUNCHES = 1   # kernel launches per compact_piece_keys call (compact.cu)


def time_k23(starts, d, nb, p_cap: int, packed: bool) -> dict:
    """K2+K3's timings at one shape (``timings``), masked_select's
    yardstick and the kernel launches of one call read from a trace;
    fails unless a call issues K23_LAUNCHES launches. The bound: the
    flags, each piece's first min(length, 16) bytes and nbytes read, six
    int32 per slot and n_pieces written; B * N operations."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP

    B, N = d.shape

    def fn():
        return CP.compact_piece_keys(starts, d, nb, p_cap, packed=packed)

    key_bytes = int(torch.clamp(fn()[1], max=16).sum())
    flag_bytes = B * N / 8 if packed else B * N
    t = timings(fn, lambda: CP.compact_piece_keys_plain(
        starts, d, nb, p_cap, packed=packed),
        flag_bytes + key_bytes + 8 * B + 24 * B * p_cap, B * N)
    n_launch = traced(fn)[2]
    if n_launch != K23_LAUNCHES:
        raise AssertionError(f"K2+K3 issued {n_launch} kernel launches in "
                             f"one call at {(B, N)}, not {K23_LAUNCHES}")
    t["launches_per_call"] = n_launch
    flags = BP.unpack_mask(starts) if packed else starts.to(torch.bool)
    idx = torch.arange(N, device=d.device).expand(B, N)
    t.update(library(lambda: torch.masked_select(idx, flags),
                     "masked_select of the start positions only (no keys, "
                     "no lengths)"))
    return t


def show(t: dict) -> str:
    s = (f"{t['ms']:.4f} ms on the device ({t['call_ms']:.4f} ms per "
         f"synchronized call; plain {t['plain_ms']:.3f} ms, bound "
         f"{t['bound_ms']:.5f} ms by {t['bound_by']})")
    if "launches_per_call" in t:
        s += f"; {t['launches_per_call']:g} kernel launch per call (trace)"
    if "library" in t:
        how = (f"{t['library_traces']} trace" if "library_traces" in t
               else "CUDA events")
        s += (f"; {t['library']}: {t['library_ms']:.4f} ms on the device "
              f"({how}), {t['library_call_ms']:.4f} ms per call")
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
    for prof in PROFILES:
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
    t = time_k23(starts, by, nb, p_cap, True)
    print(f"K2+K3 compact_piece_keys [stream {(B, N)} packed flags, "
          f"{sum(npc)} pieces]: {show(t)}")
    # edge rows: seven empty windows and one window that is one piece
    # (window 3, N letters): one block finds that piece's end, and the
    # fill blocks write every other slot
    nb_edge = torch.zeros_like(nb)
    nb_edge[3] = N
    edge_words = BP.piece_starts_bits(by, nb_edge)
    edge = {}
    for packed, st in ((True, edge_words),
                       (False, BP.unpack_mask(edge_words))):
        e = max_abs_err(
            CP.compact_piece_keys(st, by, nb_edge, p_cap, packed=packed),
            CP.compact_piece_keys_plain(st, by, nb_edge, p_cap,
                                        packed=packed))
        err = max(err, e)
        at = (f"edge (8, {N}) {'packed' if packed else 'byte'} flags: 7 "
              "empty windows + 1 one-piece window")
        edge[at] = time_k23(st, by, nb_edge, p_cap, packed)
        print(f"K2+K3 compact_piece_keys [{at}]: max_abs_err {e}; "
              f"{show(edge[at])}")
    if err:
        raise AssertionError("K2+K3 differs from its plain version on the "
                             "edge rows")
    rows.append(dict(
        name="compact_piece_keys", route="cuda",
        source="tokendagger_tpu_torch/csrc/compact.cu",
        replaces="tokendagger_tpu/ops/compact_pallas.py:288 (compact_tiles) "
                 "+ :561 (degap_keys)",
        max_abs_err=err, **t, **by_shape(edge)))

    # ---- K4: miss-span compaction at finalize's shapes ----
    sb, pl = got[0], got[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    live = torch.arange(p_cap, device=dev) < torch.clamp(got[6], max=p_cap)[:, None]
    miss = live & (torch.rand((B, p_cap), generator=g, device=dev) < 0.05)
    miss[0] = live[0]          # every live slot missed
    k_got = CP.compact_by_mask([sb, pl], miss)
    k_want = CP.compact_by_mask_plain([sb, pl], miss)
    err = k4_err = max_abs_err(k_got, k_want)
    _, n_ev, n_kern = traced(lambda: CP.compact_by_mask([sb, pl], miss))
    print(f"K4 compact_by_mask: max_abs_err {err}; {n_kern} kernel launch "
          f"per call ({n_ev} kernel events)")
    if err:
        raise AssertionError("K4 differs from its plain version")
    if n_kern != 1:
        raise AssertionError(f"K4 launched {n_kern} kernels in one call")
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


def check_k1_groups(seed: int, dev) -> tuple[int, dict]:
    """K1's byte entry on more windows than the card holds its blocks
    (300 of 1024 bytes: groups of one block per window) against its plain
    version, every profile; returns the largest error and the
    timings at that shape."""
    from tokendagger_tpu_torch.ops import bitplane as BP

    B, N = 300, 1024
    rng = np.random.default_rng(seed + 300)
    by = torch.from_numpy(rng.integers(0, 128, (B, N)).astype(np.uint8))
    text = np.frombuffer(corpus(B * N, seed + 12).encode(), np.uint8).copy()
    by[::2] = torch.from_numpy(text[: (B + 1) // 2 * N].reshape(-1, N))
    nb = torch.from_numpy(rng.integers(0, N + 1, B).astype(np.int32))
    nb[:3] = torch.tensor([0, N, 33])
    by, nb = by.to(dev), nb.to(dev)
    err = 0
    for prof in PROFILES:
        err = max(err, max_abs_err(
            [BP.piece_starts_bits(by, nb, profile=prof)],
            [BP.piece_starts_bits_plain(by, nb, profile=prof)]))
    spw = BP.starts_blocks_per_window("bytes", B, N)
    passes = BP.starts_passes("llama4", N)
    t = timings(lambda: BP.piece_starts_bits(by, nb),
                lambda: BP.piece_starts_bits_plain(by, nb),
                B * N + B * N / 8 + 4 * B, passes * B * N / 32, plain_reps=3)
    t["blocks_per_window"] = spw
    print(f"K1 piece_starts {(B, N)} (more windows than resident blocks): "
          f"max_abs_err {err} over the profiles; {spw} blocks per window; "
          f"{show(t)}")
    if err or spw < 1:
        raise AssertionError(f"K1 at {(B, N)} differs from its plain version")
    return err, {f"{B} windows {(B, N)}": t}


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


PROBE_OPS = 32     # 32-bit operations a piece: the hash, 8 slot compares


def probe_args(keys) -> list:
    """The probe's arguments (k0..k3, length) from K2+K3's outputs."""
    return [keys[2], keys[3], keys[4], keys[5], keys[1]]


def probe_err(q, rows, mask: int) -> int:
    from tokendagger_tpu_torch.ops import join as J

    return max_abs_err([J.vocab_probe8(*q, rows, mask)],
                       [J.vocab_probe8_plain(*q, rows, mask)])


def probe_edges(q, rows) -> list:
    """``q`` with, each alone, row 0 dead (length 0, zero keys), the last
    row of length -1 with zero keys (it hits an empty slot, rank 0), and
    row 0 all hits on the table's full buckets (8 live slots, where the
    table dropped entries)."""
    live = rows[:, 32:40] >= 0
    full = live.all(dim=1).nonzero().flatten()
    r = rows[full if full.numel() else live.any(dim=1).nonzero().flatten()]
    ent = [r[:, 8 * j:8 * j + 8].reshape(-1) for j in range(5)]
    P = q[0].shape[-1]
    hits = [e.repeat(-(-P // e.numel()))[:P] for e in ent]
    out = []
    for row, vals in ((0, [0, 0, 0, 0, 0]), (-1, [0, 0, 0, 0, -1]),
                      (0, hits)):
        out.append([_one_row(x, row, v) for x, v in zip(q, vals)])
    return out


def probe_bytes(q, mask: int) -> tuple[int, torch.Tensor]:
    """The probe's bytes bound at ``q``: 20 B of keys and 4 B of rank a
    piece, and each 192-byte table row the pieces touch, once; and the
    pieces' rows."""
    from tokendagger_tpu_torch.ops import join as J

    h = J._mix(*J.vhash_ab(*q), 0, mask).reshape(-1)
    return 192 * torch.unique(h).numel() + 24 * h.numel(), h


def time_probe(q, rows, mask: int) -> dict:
    """The probe kernel's timings at ``q`` (``timings``), with
    ``rows.index_select(0, h)`` alone as its library yardstick: the row
    gather any torch formulation pays, given the rows' indices. That call
    does not synchronize, so it is timed as the kernel is (``device_ms``:
    a trace late in this script can hold no kernel event)."""
    from tokendagger_tpu_torch.ops import join as J

    n_bytes, h = probe_bytes(q, mask)
    t = timings(lambda: J.vocab_probe8(*q, rows, mask),
                lambda: J.vocab_probe8_plain(*q, rows, mask), n_bytes,
                PROBE_OPS * h.numel(), plain_reps=3)

    def gather():
        return rows.index_select(0, h)

    t.update(library_ms=device_ms(gather), library_call_ms=median_ms(gather),
             library="rows.index_select(0, h) alone: the row gather (no "
                     "hash, no compare)")
    return t


@functools.lru_cache(maxsize=2)
def standin_table(seed: int, dev) -> tuple[torch.Tensor, int, int]:
    """The vhash8 table of the engine phase's stand-in on ``dev``: (rows,
    mask, entries dropped from full buckets)."""
    from tokendagger_tpu_torch.tables import build_vhash8

    ranks = standin_vocab(200_000, seed, extra=multiscript(1 << 20,
                                                          seed + 4))
    rows, mask, dropped = build_vhash8(ranks)
    return torch.from_numpy(rows).to(dev), mask, dropped


def check_probe_kernel(seed: int, dev) -> dict:
    """The whole-piece probe kernel against its plain version on the
    stand-in's table (the engine phase's 200,000 ranks, 2^18 buckets) at
    the stream batch's shape: the keys K2+K3 gives check_kernels' edge
    windows, and the same with edge rows (``probe_edges``); timed at
    both. Returns its row of the kernels line."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops.fused import caps_for

    rows, mask, dropped = standin_table(seed, dev)
    p_cap = caps_for(WINDOW)["p_cap"]
    by, nb = edge_windows(seed, WINDOW, dev)
    q = probe_args(CP.compact_piece_keys(BP.piece_starts_bits(by, nb), by,
                                         nb, p_cap, packed=True))
    edges = probe_edges(q, rows)
    err = max(probe_err(x, rows, mask) for x in [q] + edges)
    shape = tuple(q[0].shape)
    print(f"probe vocab_probe8: table {tuple(rows.shape)} ({dropped} "
          f"dropped); max_abs_err {err} at {shape} (stream keys and three "
          "edge rows)")
    if err:
        raise AssertionError("the probe kernel differs from its plain "
                             "version")
    t = time_probe(q, rows, mask)
    print(f"probe vocab_probe8 [stream {shape}, "
          f"{int((q[4] > 0).sum())} live]: {show(t)}")
    at = f"edge {shape}: row 0 all hits in full buckets"
    edge = {at: time_probe(edges[2], rows, mask)}
    print(f"probe vocab_probe8 [{at}]: {show(edge[at])}")
    return dict(
        name="vocab_probe8", route="cuda",
        source="tokendagger_tpu_torch/csrc/probe.cu",
        replaces="tokendagger_tpu/ops/join.py:339 (vocab_probe8t_chunks, "
                 "body _probe8t_core :287; XLA, no pallas_call)",
        max_abs_err=err, **t, **by_shape(edge))


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
        for prof in PROFILES:
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

    # ---- K1 under kimi: Han-heavy windows at the engine's 1 MB and 4 MB
    # shapes, also with an empty window and a ragged length; timed beside
    # llama4 on the same window ----
    more = {"engine 16 MB (1, 16777216)": timing["16 MB"]}
    for label, N in (("1 MB", 1 << 20), ("4 MB", ENGINE_WINDOW)):
        w = torch.from_numpy(np.frombuffer(han_bytes(seed, N), np.uint8)
                             .reshape(1, N).copy()).to(dev)
        nb = torch.tensor([N], dtype=torch.int32, device=dev)
        cp, m = PT.utf8_decode(w, nb)[::3]
        err = 0
        for mm in (m, torch.zeros_like(m), torch.full_like(m, 12345)):
            got = BP.piece_starts_chars(cp, mm, profile="kimi",
                                        packed_out=True)
            want = BP.piece_starts_chars_plain(cp, mm, profile="kimi")
            err = max(err, max_abs_err([got], [want]))
        if err:
            raise AssertionError(f"K1 codepoint entry kimi differs on the "
                                 f"Han-heavy {label} window")
        cp_err = max(cp_err, err)
        passes = BP.starts_passes("kimi", N)
        t = timings(
            lambda: BP.piece_starts_chars(cp, m, profile="kimi",
                                          packed_out=True),
            lambda: BP.piece_starts_chars_plain(cp, m, profile="kimi"),
            4 * N + N / 8 + 4, passes * N / 32, plain_reps=3)
        t.update(passes=passes,
                 blocks_per_window=k1_blocks("codepoints", 1, N))
        llama = device_ms(lambda: BP.piece_starts_chars(cp, m,
                                                        packed_out=True))
        more[f"engine kimi Han {label} (1, {N})"] = t
        more[f"engine llama4 Han {label} (1, {N})"] = dict(ms=llama)
        print(f"K1 piece_starts_cp[kimi] Han-heavy {label} window "
              f"({int(m)} chars): max_abs_err {err}; {show(t)}; {passes} "
              f"passes; llama4 on the same window {llama:.4f} ms on the "
              "device")
    rows.append(dict(
        name="piece_starts_cp", route="cuda",
        source="tokendagger_tpu_torch/csrc/piece_starts.cu",
        replaces="tokendagger_tpu/ops/bitplane.py:1152",
        max_abs_err=cp_err, **timing["4 MB"], library_ms=None,
        **by_shape(more)))
    return rows


SHAPE_KEYS = ("ms", "call_ms", "plain_ms", "bound_ms", "blocks_per_window",
              "library_ms", "launches_per_call", "merges",
              "longest_row_merges", "latency_floor_ms", "lanes_per_row")


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
    from tokendagger_tpu_torch.ops import join as J
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
               CP.compact_by_mask, J.vocab_probe8)
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
    return dict(zip(("piece_starts", "compact_piece_keys", "compact_by_mask",
                     "vocab_probe8"), launches))


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
    from tokendagger_tpu_torch.ops import join as J
    from tokendagger_tpu_torch.ops import pretokenize as PT

    return dict(utf8_decode_block=PT.utf8_decode_block,
                piece_starts_cp=BP.piece_starts_chars,
                piece_starts_rows=BP.piece_starts_rows,
                compact_piece_keys=CP.compact_piece_keys,
                compact_by_mask=CP.compact_by_mask,
                vocab_probe8=J.vocab_probe8)


def first_diff(a: list, b: list) -> int:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


@functools.lru_cache(maxsize=1)
def engine_texts(seed: int, mb: int) -> tuple[str, str]:
    """The engine phase's >= mb MB of multi-script text, and the same with
    specials sprinkled over its last third."""
    plain_text = multiscript(mb << 20, seed + 5)
    return plain_text, with_specials(plain_text, seed + 6,
                                     start=2 * len(plain_text) // 3)


def run_engine(seed: int, mb: int, dev, *,
               n_ranks=200_000) -> tuple[dict, dict, dict]:
    """Tokenizer(backend="device") over >= mb MB of multi-script text with
    specials; returns the engine kernels' launch counts, their largest
    errors against the plain versions on the engine's windows, and the
    timings of K2+K3 and K4 at the engine's shapes."""
    from tokendagger_tpu_torch import (
        LLAMA4_PATTERN, EngineStats, HostEngine, Tokenizer,
    )

    t = time.perf_counter()
    ranks = standin_vocab(n_ranks, seed, extra=multiscript(1 << 20,
                                                          seed + 4))
    specials = {s: n_ranks + i for i, s in enumerate(SPECIALS)}
    plain_text, text = engine_texts(seed, mb)
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
    # K1's row entry runs only for a window of at most 4 KB (a short
    # segment's last), which this text need not have
    if dev != "cpu" and any(v == 0 for n, v in launches.items()
                            if n != "piece_starts_rows"):
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
    synchronized calls), K2+K3's times on its byte flags and K4's at its
    three shapes there (the decode's compaction and finalize_host's two),
    and the probe kernel's on its keys. Returns the largest error of each
    kernel, and the timings of K2+K3, K4 and the probe by kernel and
    shape."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import pretokenize as PT
    from tokendagger_tpu_torch.ops.fused import caps_for, finalize_host
    from tokendagger_tpu_torch.ops.join import vocab_probe8

    errs = dict.fromkeys(("utf8_decode_block", "piece_starts_cp",
                          "compact_piece_keys", "compact_by_mask",
                          "vocab_probe8"), 0)
    k4_times: dict = {}
    k23_times: dict = {}
    probe_times: dict = {}
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
        q = probe_args(keys)
        e["vocab_probe8"] = max(probe_err(x, rows, mask)
                                for x in [q] + probe_edges(q, rows))
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
        at = f"engine {label} (1, {N}) byte flags"
        k23_times[at] = time_k23(stb, d, nb, p_cap, False)
        print(f"K2+K3 compact_piece_keys [{at}, {npc} pieces]: "
              f"{show(k23_times[at])}")
        at = f"engine {label} (1, {p_cap})"
        probe_times[at] = time_probe(q, rows, mask)
        print(f"probe vocab_probe8 [{at}, {npc} pieces]: "
              f"{show(probe_times[at])}")
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
    return errs, dict(compact_by_mask=k4_times, compact_piece_keys=k23_times,
                      vocab_probe8=probe_times)


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
                    "compact_by_mask", "compact_record", "expand_route",
                    "vocab_probe8")


def resident_counters():
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import join as J
    from tokendagger_tpu_torch.ops import pretokenize as PT

    return dict(utf8_decode_block=PT.utf8_decode_block,
                piece_starts_cp=BP.piece_starts_chars,
                piece_starts_words=BP.piece_starts_words,
                compact_piece_keys=CP.compact_piece_keys,
                compact_by_mask=CP.compact_by_mask,
                compact_record=CP.compact_record,
                expand_route=CP.expand_route, vocab_probe8=J.vocab_probe8)


# each kernel's launcher, by module: the one place its wrapper launches it
LAUNCHERS = (("utf8_decode_block", "pretokenize", "_launch_k9"),
             ("piece_starts", "bitplane", "_launch_k1"),
             ("piece_starts_cp", "bitplane", "_launch_k1_cp"),
             ("piece_starts_words", "bitplane", "_launch_k1_words"),
             ("compact_piece_keys", "compact", "_launch_k2k3"),
             ("compact_by_mask", "compact", "_launch_k4"),
             ("compact_record", "compact", "_launch_k5k6"),
             ("expand_route", "compact", "_launch_k7k8"),
             ("merge", "merge", "_launch"),
             ("vocab_probe8", "join", "_launch_probe8"))


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
              f"calibration_ms {r.calibration_ms})")
        show_trace(f"resident {label}", r)
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
                "expand_route"] != per * runs or run["vocab_probe8"] != runs:
            raise AssertionError(f"resident {label}: K5+K6/K7+K8 or the "
                                 f"probe launched {run} times in {runs} "
                                 "pipeline runs")
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
    times at each shape; then the hot-piece route's kernels beside the
    probe kernel on every slot of the probe's shape."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import join as J

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
        _, n_ev, n_kern = traced(lambda: CP.compact_record(
            arrays, mask, cap=cap, fill=fill))
        print(f"K5+K6 compact_record [{name}: {len(arrays)} x {(B, N)} -> "
              f"cap {cap}]: max_abs_err {e5}, {n_kern} kernel launch per "
              f"call ({n_ev} kernel events); K7+K8 expand_route: "
              f"max_abs_err {e7} (main-path inputs and edge rows)")
        if e5 or e7:
            raise AssertionError(f"K5-K8 differ from their plain versions "
                                 f"at the {name} shape")
        if n_kern != 1:
            raise AssertionError(f"K5+K6 launched {n_kern} kernels in one "
                                 "call")
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
    # the hot-piece route's kernels against the probe kernel on every slot
    keys, unknown, u_cap, _ = inputs[k5[2]]
    pk = next(k for k in inputs if k[0] == "vocab_probe8")
    *dq, vrows, vmask = inputs[pk]
    dense_ms = device_ms(lambda: J.vocab_probe8(*dq, vrows, vmask))
    all_ms = device_ms(lambda: J.vocab_probe8(*keys, vrows, vmask))
    route_ms = t5["probe"]["ms"] + dense_ms + t7["probe"]["ms"]
    print(f"hot-piece route (auto run), device-only ms: K5+K6 "
          f"{t5['probe']['ms']:.4f}, probe kernel on the {tuple(dq[0].shape)} "
          f"prefix {dense_ms:.4f}, K7+K8 {t7['probe']['ms']:.4f}: "
          f"{route_ms:.4f} without the hot-key compare (the probe stage's "
          f"trace time holds it); probe kernel on all "
          f"{tuple(keys[0].shape)} slots {all_ms:.4f}")
    for nm, src_, err, t in (
            ("compact_record", "tokendagger_tpu/ops/compact_pallas.py:434 "
             "(compact_tiles_masked) + :624 (degap_record)", err5, t5),
            ("expand_route", "tokendagger_tpu/ops/compact_pallas.py:670 "
             "(regap_replay) + :728 (expand_tiles_replay)", err7, t7)):
        rows[nm] = dict(
            name=nm, route="cuda", source="tokendagger_tpu_torch/csrc/route.cu",
            replaces=src_, max_abs_err=err, **t["decode"], **by_shape(t))

    # ---- K1's class-word entry: the auto run's class words ----
    words, m, _ = inputs[k1[0]]
    werr = 0
    short = m.clone()
    short[0] = 12345          # a ragged length inside the first segment
    short[1] = 0              # an empty window
    for prof in PROFILES:
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
                  "compact_piece_keys", "compact_by_mask", "merge",
                  "vocab_probe8")


def _fingerprint(args) -> str:
    """A hash of a launch's arguments: every tensor's dtype, shape and
    bytes, and the scalars."""
    import hashlib

    h = hashlib.sha1()
    for a in args:
        for x in (a if isinstance(a, list) else [a]):
            if isinstance(x, torch.Tensor):
                h.update(repr((x.dtype, tuple(x.shape))).encode())
                h.update(x.cpu().numpy().tobytes())
            else:
                h.update(repr(x).encode())
    return h.hexdigest()


def _one_row(x: torch.Tensor, row: int, value) -> torch.Tensor:
    y = x.clone()
    y[row] = value
    return y


def check_resident_shared(runs: dict, seed: int, dev) -> tuple[dict, dict]:
    """The kernels the single-window, batched and resident paths share
    with the other paths (K9, K1's codepoint entry, K2+K3, K4, the merge)
    against their plain versions on the inputs each run gave them
    (``runs``: label -> the run's ``recorded_inputs``), each distinct
    input once, and on edge rows at the same shapes, each edge alone so
    that a one-row batch takes them all: random bytes for K9; a ragged
    and an empty window for K1 (every profile); an empty window for
    K2+K3; an all-kept and an empty row for K4; an empty and a full-width
    row for the merge; a dead row, a row of length -1 and a row of hits in
    full buckets for the probe. Times each kernel once at each shape.
    Returns each kernel's largest error, and its timings by shape."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import merge as M
    from tokendagger_tpu_torch.ops import pretokenize as PT

    todo: dict = {}
    for label, seen in runs.items():
        for key, args in seen.items():
            if key[0] in SHARED_KERNELS:
                entry = todo.setdefault(_fingerprint(args), (key, [], args))
                entry[1].append(label)
    errs = dict.fromkeys(SHARED_KERNELS, 0)
    times: dict = {k: {} for k in SHARED_KERNELS}
    timed = set()
    g = torch.Generator(device=dev).manual_seed(seed)
    for key, labels, args in todo.values():
        name = key[0]
        t = None
        if name == "utf8_decode_block":
            (d,) = args
            B, N = shape = d.shape
            edge = _one_row(d, 0, torch.randint(
                0, 256, (N,), generator=g, device=dev, dtype=torch.uint8))
            err = max(max_abs_err(PT.utf8_decode_block(x),
                                  PT.utf8_decode_block_plain(x))
                      for x in (d, edge))
            if key not in timed:
                t = timings(lambda: PT.utf8_decode_block(d),
                            lambda: PT.utf8_decode_block_plain(d),
                            9 * B * N, 20 * B * N)
        elif name == "piece_starts_cp":
            cp, m, _ = args
            B, C = shape = cp.shape
            # a ragged length inside the first segment; an empty window
            variants = (m, _one_row(m, 0, min(12345, C)), _one_row(m, -1, 0))
            by_prof = {}
            for prof in PROFILES:
                by_prof[prof] = max(max_abs_err(
                    [BP.piece_starts_chars(cp, mm, profile=prof,
                                           packed_out=True)],
                    [BP.piece_starts_chars_plain(cp, mm, profile=prof)])
                    for mm in variants)
            print(f"K1 piece_starts_cp {(B, C)} [{labels[0]}]: max_abs_err "
                  f"by profile {json.dumps(by_prof)}")
            err = max(by_prof.values())
            if key not in timed:
                passes = BP.starts_passes("llama4", C)
                t = timings(
                    lambda: BP.piece_starts_chars(cp, m, packed_out=True),
                    lambda: BP.piece_starts_chars_plain(cp, m),
                    4 * B * C + B * C / 8 + 4 * B, passes * B * C / 32,
                    plain_reps=3)
                t["blocks_per_window"] = k1_blocks("codepoints", B, C)
        elif name == "compact_piece_keys":
            starts, d, nb, p_cap, packed = args
            B, N = d.shape
            shape = (B, N, p_cap)
            err = max(max_abs_err(
                CP.compact_piece_keys(starts, d, n, p_cap, packed=packed),
                CP.compact_piece_keys_plain(starts, d, n, p_cap,
                                            packed=packed))
                for n in (nb, _one_row(nb, 0, 0)))
            if key not in timed:
                t = time_k23(starts, d, nb, p_cap, packed)
        elif name == "compact_by_mask":
            arrays, mask, fill = args
            B, P = shape = mask.shape
            err = max(max_abs_err(CP.compact_by_mask(arrays, mm, fill=fill),
                                  CP.compact_by_mask_plain(arrays, mm,
                                                           fill=fill))
                      for mm in (mask, _one_row(mask, 0, True),
                                 _one_row(mask, -1, False)))
            if key not in timed:
                kept = int(mask.sum())
                k = len(arrays)
                t = timings(
                    lambda: CP.compact_by_mask(arrays, mask, fill=fill),
                    lambda: CP.compact_by_mask_plain(arrays, mask,
                                                     fill=fill),
                    B * P + 4 * k * kept + 4 * k * B * P, B * P)
        elif name == "vocab_probe8":
            *q, rows, mask = args
            shape = q[0].shape
            err = max(probe_err(x, rows, mask)
                      for x in [q] + probe_edges(q, rows))
            if key not in timed:
                t = time_probe(q, rows, mask)
        else:                                       # merge
            by, ln, byte_rank, rows, mask, lut = args
            R, W = shape = by.shape

            def plain(n):
                return M.merge_rows_local(by, n, byte_rank, rows, mask=mask,
                                          pair_lut=lut)

            err = max(max_abs_err(
                M.merge_rows(by, n, byte_rank, rows, mask, lut), plain(n))
                for n in (ln, _one_row(ln, 0, 0), _one_row(ln, -1, W)))
            if key not in timed:
                n_bytes, n_ops, n_merges, longest = merge_cost(
                    ln, plain(ln)[1], W, lut is not None)
                t = timings(lambda: M.merge_rows(by, ln, byte_rank, rows,
                                                 mask, lut),
                            lambda: plain(ln), n_bytes, n_ops, plain_reps=3)
                t.update(merges=n_merges, longest_row_merges=longest)
        at = f"{labels[0]} {tuple(shape)}"
        also = ""
        if len(labels) > 1:
            also = f" (the same inputs in: {', '.join(labels[1:])})"
        print(f"{name} [{at}]: max_abs_err {err} (main-path inputs and "
              f"edge rows){also}" + (f"; {show(t)}" if t else ""))
        if err:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{at}")
        errs[name] = max(errs[name], err)
        if t is not None:
            timed.add(key)
            times[name][at] = t
    missing = [k for k in SHARED_KERNELS if not times[k]]
    if missing:
        raise AssertionError(f"no recorded inputs for {missing}")
    return errs, times


GRID_SHAPES = ((4096, 256), (1024, 1024), (256, 4096))


def grid_rows_bytes(seed: int, B: int, W: int) -> list[bytes]:
    """B rows of a (B, W) grid: an empty row, a row of exactly W chars
    (ASCII prose), one piece (W letters), all whitespace, then seeded
    multi-script rows of 1..W bytes cut at char boundaries."""
    rng = np.random.default_rng(seed)
    text = multiscript(B * W, seed).encode()
    rows = [b"", corpus(W, seed).encode()[:W], b"a" * W,
            b" \t\n " * (W // 4)]
    pos = 0
    for k in rng.integers(1, W + 1, B - len(rows)).tolist():
        if pos + k > len(text):
            pos = 0
        rows.append(text[pos:pos + k].decode("utf-8", "ignore").encode())
        pos += k
    return rows


def stage_rows(rows: list[bytes], W: int, dev):
    by = np.zeros((len(rows), W), np.uint8)
    nb = np.zeros(len(rows), np.int32)
    for r, raw in enumerate(rows):
        by[r, : len(raw)] = np.frombuffer(raw, np.uint8)
        nb[r] = len(raw)
    return torch.from_numpy(by).to(dev), torch.from_numpy(nb).to(dev)


def check_grid_kernels(seed: int, dev) -> tuple[dict, dict, dict]:
    """Every kernel of the batched grids against its plain version at the
    three grid shapes, stage by stage as ``ops/batched.resolve_grid``
    runs them, on seeded multi-script rows with edge rows (empty, exactly
    W chars, one piece, all whitespace): K9, K4 in the decode, K1's row
    entry (every profile, and kimi on Han-heavy rows of the same
    lengths), K2+K3 on byte flags with p_cap = W, the
    probe on the stand-in's table (with its edge rows) and K4 in
    finalize_host. Returns K1's row-entry row of the kernels line, and
    each kernel's largest error and timings by shape."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import pretokenize as PT
    from tokendagger_tpu_torch.ops.fused import finalize_host

    names = ("utf8_decode_block", "piece_starts_rows", "compact_piece_keys",
             "compact_by_mask", "vocab_probe8")
    vrows, vmask, _ = standin_table(seed, dev)
    errs = dict.fromkeys(names, 0)
    times: dict = {n: {} for n in names}
    passes = {}
    for B, W in GRID_SHAPES:
        by, nb = stage_rows(grid_rows_bytes(seed + W, B, W), W, dev)
        at = f"grid ({B}, {W})"
        e = {}
        cp_at, lead = PT.utf8_decode_block(by)
        e["utf8_decode_block"] = max_abs_err(
            (cp_at, lead), PT.utf8_decode_block_plain(by))
        times["utf8_decode_block"][at] = timings(
            lambda: PT.utf8_decode_block(by),
            lambda: PT.utf8_decode_block_plain(by), 9 * B * W, 20 * B * W)
        idx = torch.arange(W, dtype=torch.int32, device=dev)
        is_lead = (lead != 0) & (idx < nb[:, None])
        arrs = [cp_at, idx.expand(B, W).contiguous()]
        k4 = [max_abs_err(CP.compact_by_mask(arrs, is_lead, fill=0),
                          CP.compact_by_mask_plain(arrs, is_lead, fill=0))]
        kept = int(is_lead.sum())
        times["compact_by_mask"][f"{at} decode k 2"] = timings(
            lambda: CP.compact_by_mask(arrs, is_lead, fill=0),
            lambda: CP.compact_by_mask_plain(arrs, is_lead, fill=0),
            B * W + 8 * kept + 8 * B * W, B * W)
        cp, cob, _, m = PT.utf8_decode(by, nb)
        e1 = 0
        for prof in PROFILES:
            n0 = BP.piece_starts_rows.launches
            got = BP.piece_starts_chars(cp, m, profile=prof, packed_out=True)
            if BP.piece_starts_rows.launches != n0 + 1:
                raise AssertionError(f"piece_starts_chars at {(B, W)} did "
                                     "not take K1's row entry")
            err = max_abs_err(
                [got], [BP.piece_starts_chars_plain(cp, m, profile=prof)])
            print(f"K1 piece_starts_rows[{prof}] {at}: max_abs_err {err}")
            e1 = max(e1, err)
        # kimi on Han-heavy rows of the same lengths (the empty row too)
        han, pos, hrows = han_bytes(seed + W, B * W), 0, []
        for k in nb.tolist():
            hrows.append(han[pos:pos + k].decode("utf-8", "ignore").encode())
            pos += k
        hcp, _, _, hm = PT.utf8_decode(*stage_rows(hrows, W, dev))
        n0 = BP.piece_starts_rows.launches
        got = BP.piece_starts_chars(hcp, hm, profile="kimi", packed_out=True)
        if BP.piece_starts_rows.launches != n0 + 1:
            raise AssertionError(f"kimi rows at {(B, W)} did not take K1's "
                                 "row entry")
        err = max_abs_err(
            [got], [BP.piece_starts_chars_plain(hcp, hm, profile="kimi")])
        print(f"K1 piece_starts_rows[kimi] {at} Han-heavy rows: max_abs_err "
              f"{err}")
        e1 = max(e1, err)
        e["piece_starts_rows"] = e1
        times["piece_starts_rows"][f"{at} kimi Han"] = timings(
            lambda: BP.piece_starts_rows(hcp, hm, profile="kimi"),
            lambda: BP.piece_starts_chars_plain(hcp, hm, profile="kimi"),
            4 * B * W + B * W / 8 + 4 * B,
            BP.starts_passes("kimi", W) * B * W / 32, plain_reps=3)
        passes[at] = BP.starts_passes("llama4", W)
        times["piece_starts_rows"][at] = timings(
            lambda: BP.piece_starts_rows(cp, m),
            lambda: BP.piece_starts_chars_plain(cp, m),
            4 * B * W + B * W / 8 + 4 * B, passes[at] * B * W / 32,
            plain_reps=3)
        if W % 1024 == 0:
            # the window entry on the same rows, for comparison: the
            # cooperative launch spreads B rows over the card's blocks
            # (in groups past its co-resident blocks), a grid barrier
            # per pass
            coop = device_ms(lambda: BP._launch_k1_cp(cp, m, "llama4"))
            spw = BP.starts_blocks_per_window("codepoints", B, W)
            print(f"K1 window entry on the rows of {at}: {coop:.4f} ms on "
                  f"the device, {spw} blocks per row (row entry "
                  f"{times['piece_starts_rows'][at]['ms']:.4f} ms)")
        st = BP.unpack_mask(BP.piece_starts_rows(cp, m))
        stb = PT.starts_to_bytes(st, cob, by, nb)
        keys = CP.compact_piece_keys(stb, by, nb, W)
        e["compact_piece_keys"] = max_abs_err(
            keys, CP.compact_piece_keys_plain(stb, by, nb, W))
        npc = int(keys[6].sum())
        k23_at = f"{at} byte flags p_cap {W}"
        times["compact_piece_keys"][k23_at] = time_k23(stb, by, nb, W, False)
        q = probe_args(keys)
        e["vocab_probe8"] = max(probe_err(x, vrows, vmask)
                                for x in [q] + probe_edges(q, vrows))
        times["vocab_probe8"][at] = time_probe(q, vrows, vmask)
        # finalize_host's two K4 calls, with every piece longer than 6
        # bytes missed
        rank = torch.where(keys[1] > 6, -1, keys[2] & 0xFFFF)
        fin = (keys[0], keys[1], rank, keys[6], nb)
        with recorded_inputs() as fin_k4:
            got = finalize_host(*fin, p_cap=W)
        want = finalize_host(*(a.cpu() for a in fin), p_cap=W)
        k4.append(max_abs_err([g.cpu() for g in got], list(want)))
        e["compact_by_mask"] = max(k4)
        for key, (arrays, mm, fill) in fin_k4.items():
            if key[0] != "compact_by_mask":
                continue
            k, kept, P = len(arrays), int(mm.sum()), mm.numel()
            times["compact_by_mask"][
                f"{at} finalize k {k} fill {fill}"] = timings(
                lambda: CP.compact_by_mask(arrays, mm, fill=fill),
                lambda: CP.compact_by_mask_plain(arrays, mm, fill=fill),
                P + 4 * k * kept + 4 * k * P, P)
        print(f"grid {(B, W)} ({int(nb.sum())} B, {npc} pieces): max_abs_err "
              + ", ".join(f"{k} {v}" for k, v in e.items()))
        if any(e.values()):
            raise AssertionError(f"grid {(B, W)}: a kernel differs from its "
                                 f"plain version: {e}")
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        for name in names:
            for shape, t in times[name].items():
                if shape.startswith(at):
                    print(f"{name} [{shape}]: {show(t)}")
    first = f"grid ({GRID_SHAPES[0][0]}, {GRID_SHAPES[0][1]})"
    row_times = times.pop("piece_starts_rows")
    row = dict(
        name="piece_starts_rows", route="cuda",
        source="tokendagger_tpu_torch/csrc/piece_starts.cu",
        replaces="tokendagger_tpu/ops/bitplane.py:1152 (row entry)",
        max_abs_err=errs.pop("piece_starts_rows"), **row_times[first],
        library_ms=None, passes=passes[first], **by_shape(row_times))
    return row, errs, times


BATCH_KERNELS = ("utf8_decode_block", "piece_starts_rows", "piece_starts_cp",
                 "compact_piece_keys", "compact_by_mask", "vocab_probe8")


def count_runs(counters: dict, fn):
    """Runs ``fn`` with every kernel count set to 0 just before it;
    returns its result, its wall (s) and the counts just after it."""
    for k in counters.values():
        k.launches = 0
    t = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t
    return out, wall, {n: k.launches for n, k in counters.items()}


def batch_texts(seed: int, n: int = 10_000) -> list[str]:
    """n seeded multi-script texts of log-uniform 16-4,096 B, cut at char
    boundaries, every 8th with one of SPECIALS inside; then 8 texts of
    256 KB."""
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(np.log(16), np.log(4096), n)).astype(int)
    src = multiscript(int(lens.sum()) + (1 << 20), seed).encode()
    texts, pos = [], 0
    for i, k in enumerate(lens.tolist()):
        t = src[pos:pos + k].decode("utf-8", "ignore")
        pos += k
        if i % 8 == 0:
            j = int(rng.integers(0, len(t) + 1))
            t = t[:j] + SPECIALS[int(rng.integers(len(SPECIALS)))] + t[j:]
        texts.append(t)
    big = multiscript(8 << 18, seed + 1).encode()
    texts += [big[j << 18:(j + 1) << 18].decode("utf-8", "ignore")
              for j in range(8)]
    return texts


def engine_tokenizer(seed: int, dev, n_ranks=200_000, *,
                     backend: str = "device", tables=None):
    """The engine phase's tokenizer (its stand-in vocabulary and
    SPECIALS) on ``dev`` with ``backend``, and a host engine over the
    same."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine, Tokenizer

    ranks = standin_vocab(n_ranks, seed, extra=multiscript(1 << 20,
                                                          seed + 4))
    specials = {s: n_ranks + i for i, s in enumerate(SPECIALS)}
    tok = Tokenizer("standin", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, backend=backend, device=dev,
                    tables=tables)
    return tok, HostEngine(LLAMA4_PATTERN, ranks, specials), specials


def run_batch(seed: int, dev) -> dict:
    """Tokenizer(backend="device").encode_batch over 10,008 texts (see
    ``batch_texts``): the short spans go through grids, the 256 KB texts
    through windows. Every text's ids must equal the host engine's.
    Prints the grids by width, the segments by route, the wall rate,
    launches per segment and the device's idle share; then the same
    first 1,000 texts through grids and segment by segment through
    ``encode_stream`` (wall rate and launches per segment). Returns the
    kernels' launches."""
    from tokendagger_tpu_torch import EngineStats

    t = time.perf_counter()
    tok, host, specials = engine_tokenizer(seed, dev)
    texts = batch_texts(seed + 30)
    nbytes = sum(len(x.encode()) for x in texts)
    eng = tok._get_device()
    allowed = set(specials)
    segs = [len(s.encode()) for x in texts
            for s, sid in eng._split_specials(x, allowed) if sid is None and s]
    n_seg = len(segs)
    n_long = sum(n > 4096 for n in segs)
    tok.encode_batch(texts[:2000], allowed_special="all")  # warm-up
    print(f"batch: {len(texts)} texts, {nbytes} B, {n_seg} non-empty "
          f"segments, set-up {time.perf_counter() - t:.1f} s")
    counters = engine_counters()
    eng.stats = EngineStats()
    ids, wall, launches = count_runs(
        counters, lambda: tok.encode_batch(texts, allowed_special="all"))
    st = eng.stats
    n_launch = sum(launches.values())
    print(f"batch encode_batch: {nbytes} B in {wall:.4f} s = "
          f"{nbytes / 1e6 / wall:.2f} MB/s wall; grids by width "
          f"{json.dumps(st.grids_by_width)} ({st.grids} grids); segments "
          f"by route: grid {st.grid_rows}, stream {n_seg - st.grid_rows} "
          f"({st.windows} windows); {n_launch} launches = "
          f"{n_launch / n_seg:.4f} per segment {json.dumps(launches)}; "
          f"grid time {st.grid_s:.4f} s, spliced {st.spliced_pieces}")
    dead = [n for n in BATCH_KERNELS if not launches[n]]
    if dev != "cpu" and dead:
        raise AssertionError(f"batch: kernels never launched: {dead}")
    if st.grid_rows != n_seg - n_long or not st.grids:
        raise AssertionError(f"batch: {st.grid_rows} segments took grids, "
                             f"not {n_seg - n_long}")
    t = time.perf_counter()
    for i, x in enumerate(texts):
        want = host.encode(x, allowed)[0]
        if ids[i] != want:
            raise AssertionError(f"batch text {i} differs from the host "
                                 f"engine at id {first_diff(ids[i], want)}")
    print(f"batch ids equal the host engine ({sum(map(len, ids))} ids, "
          f"host {time.perf_counter() - t:.1f} s)")
    if dev != "cpu":
        idle_share(lambda: tok.encode_batch(texts, allowed_special="all"),
                   f"batch encode_batch of {nbytes} B")
    # the grid route against one encode_stream per segment, on the same
    # first 1,000 texts (for the rate only)
    head = texts[:1000]
    hb = sum(len(x.encode()) for x in head)
    hsegs = [s.encode() for x in head
             for s, sid in eng._split_specials(x, allowed) if sid is None and s]
    rates = {}
    for route in ("grid", "segment", "segment", "grid"):
        if route == "grid":
            fn = functools.partial(tok.encode_batch, head,
                                   allowed_special="all")
        else:
            def fn():
                out = []
                for x in head:
                    for s, sid in eng._split_specials(x, allowed):
                        if sid is not None:
                            out.append(sid)
                        elif s:
                            out.extend(eng.encode_stream(s.encode()).tolist())
                return out
        _, w, n = count_runs(counters, fn)
        rates.setdefault(route, []).append(
            (hb / 1e6 / w, sum(n.values()) / len(hsegs)))
    print(f"batch first 1,000 texts ({hb} B, {len(hsegs)} segments), two "
          "runs each: " + "; ".join(
              f"{r}: " + " / ".join(f"{mb:.2f} MB/s wall, {lp:.3f} launches "
                                    "per segment" for mb, lp in v)
              for r, v in rates.items()))
    if dev != "cpu" and rates["grid"][0][1] >= rates["segment"][0][1]:
        raise AssertionError("batch: the grids did not launch fewer kernels "
                             "per segment than the per-segment route")
    return launches


CORPUS_KERNELS = ("utf8_decode_block", "piece_starts_cp",
                  "compact_piece_keys", "compact_by_mask", "vocab_probe8")


def run_corpus(seed: int, dev, n_files: int = 32) -> dict:
    """CorpusProcessor(Tokenizer(backend="device"), num_threads=4) over
    n_files seeded multi-script files of 64-512 KB: every shard must equal
    the host engine's ids, and a second process must skip every file.
    Then 1 thread and 4 threads again, each into a fresh output, for the
    rates the pool gains (their shards must equal the first's). Returns
    the kernels' launches of the first run."""
    import tempfile
    from pathlib import Path

    from tokendagger_tpu_torch.corpus import CorpusProcessor

    tok, host, _ = engine_tokenizer(seed, dev)
    tok._get_device()  # set-up: the engine's tables, outside the wall
    rng = np.random.default_rng(seed + 40)
    sizes = rng.integers(64 << 10, (512 << 10) + 1, n_files).tolist()
    src = multiscript(sum(sizes), seed + 41).encode()
    with tempfile.TemporaryDirectory() as d:
        files, pos = [], 0
        for i, k in enumerate(sizes):
            p = Path(d) / "in" / f"doc{i:02d}.txt"
            p.parent.mkdir(exist_ok=True)
            p.write_bytes(src[pos:pos + k].decode("utf-8", "ignore").encode())
            pos += k
            files.append(p)
        nbytes = sum(p.stat().st_size for p in files)
        proc = CorpusProcessor(tok, Path(d) / "out", num_threads=4)
        manifest, wall, launches = count_runs(
            engine_counters(), lambda: proc.process(files))
        print(f"corpus: {len(files)} files, {nbytes} B in {wall:.4f} s = "
              f"{nbytes / 1e6 / wall:.2f} MB/s wall (4 threads); launches "
              f"{json.dumps(launches)}")
        dead = [n for n in CORPUS_KERNELS if not launches[n]]
        if dev != "cpu" and dead:
            raise AssertionError(f"corpus: kernels never launched: {dead}")
        t = time.perf_counter()
        for p in files:
            e = manifest["files"][str(p.resolve())]
            want = host.encode_ordinary(p.read_text(encoding="utf-8"))
            got = np.load(e["shard"]).tolist()
            if e["status"] != "done" or got != want:
                raise AssertionError(f"corpus shard of {p.name} differs "
                                     "from the host engine")
        again = CorpusProcessor(tok, Path(d) / "out", num_threads=4)
        again.process(files)
        if again.meter.bytes:
            raise AssertionError("corpus: a second process re-encoded files")
        print(f"corpus shards equal the host engine (host "
              f"{time.perf_counter() - t:.1f} s); a second process skipped "
              "every file")
        rates = {}
        for i, threads in enumerate((1, 4)):
            out = Path(d) / f"out_t{threads}_{i}"
            t = time.perf_counter()
            m = CorpusProcessor(tok, out, num_threads=threads).process(files)
            rates[threads] = nbytes / 1e6 / (time.perf_counter() - t)
            for p in files:
                key = str(p.resolve())
                if not np.array_equal(np.load(m["files"][key]["shard"]),
                                      np.load(manifest["files"][key]["shard"])):
                    raise AssertionError(f"corpus with {threads} threads: "
                                         f"the shard of {p.name} differs")
        print(f"corpus threads: 1 thread {rates[1]:.2f} MB/s wall, 4 threads "
              f"again {rates[4]:.2f} MB/s wall (fresh outputs, shards equal)")
    return launches


STREAMING_KERNELS = ("utf8_decode_block", "compact_piece_keys",
                     "compact_by_mask", "vocab_probe8")


def run_streaming(seed: int, dev) -> dict:
    """StreamingEncoder over Tokenizer(backend="device") fed 4 MB of
    multi-script text with specials in seeded chunks of 1 B-64 KB
    (log-uniform); the result must equal one encode and the host
    engine's ids. Returns the kernels' launches."""
    from tokendagger_tpu_torch import StreamingEncoder

    tok, host, specials = engine_tokenizer(seed, dev)
    tok._get_device()  # set-up: the engine's tables, outside the wall
    text = with_specials(multiscript(4 << 20, seed + 50), seed + 51,
                         every=1 << 14)
    nbytes = len(text.encode())
    rng = np.random.default_rng(seed + 52)
    chunks, i = [], 0
    while i < len(text):
        k = int(np.exp(rng.uniform(0, np.log(1 << 16))))
        chunks.append(text[i:i + k])
        i += k

    def stream():
        enc = StreamingEncoder(tok, allowed_special="all")
        out = []
        for c in chunks:
            out.extend(enc.feed(c))
        return out + enc.flush()

    counters = engine_counters()
    ids, wall, launches = count_runs(counters, stream)
    print(f"streaming: {nbytes} B in {len(chunks)} chunks, {wall:.4f} s = "
          f"{nbytes / 1e6 / wall:.2f} MB/s wall; launches "
          f"{json.dumps(launches)}")
    dead = [n for n in STREAMING_KERNELS if not launches[n]]
    if launches["piece_starts_rows"] + launches["piece_starts_cp"] == 0:
        dead.append("piece_starts (either entry)")
    if dev != "cpu" and dead:
        raise AssertionError(f"streaming: kernels never launched: {dead}")
    want = tok.encode(text, allowed_special="all")
    if ids != want or want != host.encode(text, set(specials))[0]:
        raise AssertionError(f"streaming ids differ from one encode at id "
                             f"{first_diff(ids, want)}")
    print(f"streaming ids equal one encode and the host engine "
          f"({len(ids)} ids)")
    return launches


def run_kimi(seed: int, dev) -> dict:
    """Kimi K2's pattern (the kimi profile) through Tokenizer(backend=
    "device") on a 200,000-rank stand-in that holds the pieces of some
    Han-heavy text: 8 MB of Han-heavy text, [EOS] between sub-documents
    of 256 KB and a 5 MB segment after <|im_end|> (4 MB windows cut at
    safe offsets), then encode_batch over 400 short Han-heavy texts
    (grids). Every id must equal the host engine's (Kimi's own scanner:
    ``HostEngine``, as the native engine's pair table cannot be built for
    this stand-in); the engine must have no ``regex`` split; over this
    path's own run K1 must launch once a window or batch of windows (its
    codepoint or row entry), the sub-documents must share batches, and
    its row entry must launch once a grid,
    Han pieces must be spliced and no window may take the host route.
    Returns the kernels' launches."""
    from tokendagger_tpu_torch import KIMI_PATTERN, Tokenizer

    n_ranks = 200_000
    ranks = standin_vocab(n_ranks, seed, extra=han_heavy(seed + 60)[
        : 1 << 18].decode("utf-8", "ignore"))
    specials = {"[BOS]": n_ranks, "[EOS]": n_ranks + 1,
                "<|im_end|>": n_ranks + 2}
    kw = dict(pat_str=KIMI_PATTERN, mergeable_ranks=ranks,
              special_tokens=specials)
    tok = Tokenizer("kimi", backend="device", device=dev, **kw)
    host = Tokenizer("kimi", backend="host", **kw)
    eng = tok._get_device()
    if not eng.stream or eng.host._re is not None:
        raise AssertionError("kimi: the engine would split on the host")
    raw = han_bytes(seed + 61, 8 << 20)
    subdocs = [raw[j:j + (1 << 18)].decode("utf-8", "ignore")
               for j in range(0, 3 << 20, 1 << 18)]
    text = ("[EOS]".join(subdocs) + "<|im_end|>"
            + raw[3 << 20:].decode("utf-8", "ignore"))
    rng = np.random.default_rng(seed + 62)
    short = [raw[a:a + k].decode("utf-8", "ignore") for a, k in zip(
        rng.integers(0, 1 << 20, 400).tolist(),
        rng.integers(1, 4000, 400).tolist())]
    tok.encode("中文 warm-up 2024，", allowed_special="all")
    counters = engine_counters()

    def counts():
        return {k: v for k, v in vars(eng.stats).items()
                if isinstance(v, int)} | {"grids": eng.stats.grids}

    s0 = counts()
    ids, wall, launches = count_runs(
        counters, lambda: tok.encode(text, allowed_special="all"))
    s1 = counts()
    batch, bwall, blaunch = count_runs(
        counters, lambda: tok.encode_batch(short, allowed_special="all"))
    s2 = counts()
    win = {k: s1[k] - s0[k] for k in s0}
    grid = {k: s2[k] - s1[k] for k in s0}
    nbytes = len(text.encode())
    print(f"kimi: {nbytes} B in {win['windows']} windows ({win['cut_windows']}"
          f" cut), {wall:.4f} s = {nbytes / 1e6 / wall:.2f} MB/s wall; "
          f"{win['spliced_pieces']} pieces spliced, {win['spliced_han']} of "
          f"them Han; launches {json.dumps(launches)}; batch of {len(short)} "
          f"texts: {grid['grids']} grids, {bwall:.4f} s, launches "
          f"{json.dumps(blaunch)}")
    k1 = launches["piece_starts_cp"] + launches["piece_starts_rows"]
    # one K1 launch a batch of windows
    if k1 != win["window_batches"] or not launches["piece_starts_cp"]:
        raise AssertionError(f"kimi: {k1} K1 launches for "
                             f"{win['windows']} windows in "
                             f"{win['window_batches']} batches")
    if not win["windows"] > win["window_batches"]:
        raise AssertionError("kimi: no sub-documents shared a batch")
    if blaunch["piece_starts_rows"] != grid["grids"] or not grid["grids"]:
        raise AssertionError(f"kimi: {blaunch['piece_starts_rows']} K1 row "
                             f"launches for {grid['grids']} grids")
    if not win["cut_windows"] or not win["spliced_han"]:
        raise AssertionError("kimi: no window was cut or no Han piece "
                             "spliced")
    if win["host_advance_windows"] or grid["host_advance_windows"]:
        raise AssertionError("kimi: a window took the host route")
    want = host.encode(text, allowed_special="all")
    if ids != want:
        raise AssertionError(f"kimi ids differ from the host engine's at id "
                             f"{first_diff(ids, want)}")
    if batch != host.encode_batch(short, allowed_special="all"):
        raise AssertionError("kimi batch ids differ from the host engine's")
    print(f"kimi: every id equals the host engine's ({len(ids)} "
          f"ids; host binding {host.host_binding})")
    return {k: launches[k] + blaunch[k] for k in launches}


# ===========================================================================
# The host backend (the native engine) and "auto"'s routing
# ===========================================================================


@functools.lru_cache(maxsize=1)
def host_inputs(seed: int, mb: int):
    """The engine phase's text (>= mb MB with specials) and the batch
    phase's 10,008 texts, with the host engine's ids of each (full allowed
    set; the batch texts also ordinary) and the host engine's walls."""
    tok, host, specials = engine_tokenizer(seed, "cpu")
    text = engine_texts(seed, mb)[1]
    texts = batch_texts(seed + 30)
    allowed = set(specials)
    t = time.perf_counter()
    want = host.encode(text, allowed)[0]
    text_s = time.perf_counter() - t
    t = time.perf_counter()
    want_b = [host.encode(x, allowed)[0] for x in texts]
    batch_s = time.perf_counter() - t
    t = time.perf_counter()
    want_o = [host.encode_ordinary(x) for x in texts]
    ordinary_s = time.perf_counter() - t
    return dict(text=text, texts=texts, want=want, want_b=want_b,
                want_o=want_o, walls=dict(text=text_s, batch=batch_s,
                                          ordinary=ordinary_s))


def run_host(seed: int, mb: int) -> dict:
    """Tokenizer(backend="host"), the native C++ engine, over the engine
    phase's text and the batch phase's texts at 1, 4 and all cores: the
    one-call encode with specials, encode_batch with specials and
    encode_ordinary_batch, then encode and decode as routed. Every id
    must equal the host engine's (HostEngine, pure Python), whose rate is
    printed beside; the native engine must be built (no Python
    fallback). Returns the kernels' launches (none: the path is host
    only)."""
    import os

    from tokendagger_tpu_torch import native

    t = time.perf_counter()
    built = native.binding()        # g++ at first use (both libraries)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    tok = engine_tokenizer(seed, "cuda", backend="host")[0]
    eng = tok._get_native()
    hi = host_inputs(seed, mb)
    text, texts = hi["text"], hi["texts"]
    data = text.encode()
    nbytes = len(data)
    bbytes = sum(len(x.encode()) for x in texts)
    print(f"host: binding {tok.host_binding} (process: {built}; g++ "
          f"{build_s:.1f} s), "
          f"os.cpu_count {os.cpu_count()}, usable cores "
          f"{len(os.sched_getaffinity(0))}; set-up "
          f"{time.perf_counter() - t:.1f} s")
    if tok.host_binding == "python" or eng is None:
        raise AssertionError("host: the native engine did not build")
    w = hi["walls"]
    print(f"host HostEngine (pure Python): text {nbytes} B "
          f"{nbytes / 1e6 / w['text']:.2f} MB/s; batch {len(texts)} texts "
          f"{bbytes} B with specials {bbytes / 1e6 / w['batch']:.2f} MB/s, "
          f"ordinary {bbytes / 1e6 / w['ordinary']:.2f} MB/s")
    allowed = set(tok._special_tokens)

    def check(what, got, want):
        if got != want:
            bad = (first_diff(got, want) if isinstance(got[0], int) else
                   next(i for i, (a, b) in enumerate(zip(got, want))
                        if a != b))
            raise AssertionError(f"host {what}: ids differ from the host "
                                 f"engine at {bad}")

    counters = engine_counters()

    def drive():
        rates = {}
        for n in sorted({1, 4, os.cpu_count()}):
            runs = (
                ("text", nbytes, hi["want"],
                 lambda: eng.encode_with_specials(data, num_threads=n)),
                ("batch", bbytes, hi["want_b"],
                 lambda: tok.encode_batch(texts, num_threads=n,
                                          allowed_special="all")),
                ("ordinary batch", bbytes, hi["want_o"],
                 lambda: tok.encode_ordinary_batch(texts, num_threads=n)))
            for what, nb, want, fn in runs:
                walls = []
                for _ in range(2):
                    t = time.perf_counter()
                    got = fn()
                    walls.append(time.perf_counter() - t)
                    check(f"{what} at {n} threads", got, want)
                rates[(what, n)] = nb / 1e6 / min(walls)
        t = time.perf_counter()
        ids = tok.encode(text, allowed_special="all")
        enc_s = time.perf_counter() - t
        check("encode", ids, hi["want"])
        t = time.perf_counter()
        back = tok.decode(ids)
        dec_s = time.perf_counter() - t
        if back != text:
            raise AssertionError("host: decode(encode(text)) != text")
        return rates, enc_s, dec_s, len(ids)

    (rates, enc_s, dec_s, n_ids), wall, launches = count_runs(counters, drive)
    for what, base in (("text", w["text"] / nbytes),
                       ("batch", w["batch"] / bbytes),
                       ("ordinary batch", w["ordinary"] / bbytes)):
        py = 1 / base / 1e6
        print(f"host native {what}: " + ", ".join(
            f"{n} threads {r:.2f} MB/s ({r / py:.1f}x HostEngine)"
            for (k, n), r in rates.items() if k == what))
    print(f"host encode (routed, {tok._effective_threads(8)} threads): "
          f"{nbytes / 1e6 / enc_s:.2f} MB/s; decode of {n_ids} ids "
          f"{nbytes / 1e6 / dec_s:.2f} MB/s out; every id equals the host "
          f"engine's; phase {wall:.1f} s; launches {json.dumps(launches)}")
    return launches


AUTO_SIZES = (1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20,
              4 << 20, 16 << 20)
AUTO_HOST_MAX = 1 << 20     # HostEngine is timed on batches up to this


def _prefix(text: str, nbytes: int) -> str:
    return text.encode()[:nbytes].decode("utf-8", errors="ignore")


def _batch_of(texts: list[str], wants: list, nbytes: int):
    """The first of ``texts`` (cycled) that hold ``nbytes`` bytes, and
    their ids."""
    out, ids, size, i = [], [], 0, 0
    while size < nbytes:
        x = texts[i % len(texts)]
        out.append(x)
        ids.append(wants[i % len(texts)])
        size += len(x.encode())
        i += 1
    return out, ids, size


def _crossover(sizes, fast, slow) -> int | None:
    """The smallest size from which ``fast`` beats ``slow`` at every
    larger size measured (None if it does not at the largest)."""
    cross = None
    for n, f, s in zip(sizes, fast, slow):
        if s is None:
            continue
        cross = (cross or n) if f < s else None
    return cross


def run_auto(seed: int, mb: int, dev) -> dict:
    """"auto"'s routing on the card, at 1 KB to 16 MB: one text with
    specials (encode), encode_batch with specials and
    encode_ordinary_batch over the batch texts, each through the native
    engine (Tokenizer(backend="host")) and DeviceEngine
    (backend="device"), walls in turns (native, device, device, native;
    the best of each), beside HostEngine's wall (one text at every size,
    the batches up to 1 MB). Prints the dispatch probe, the walls and the
    crossovers (the smallest size from which the device is faster than
    the native engine, and than HostEngine), and checks that an "auto"
    Tokenizer chooses as its constants say and that its ids, and the
    other two's, equal the host engine's. Returns the kernels' launches
    (the device runs)."""
    from tokendagger_tpu_torch import Tokenizer

    t = time.perf_counter()
    dtok, host, specials = engine_tokenizer(seed, dev)
    if dtok._get_native() is None:
        raise AssertionError("auto: the native engine did not build")
    ntok = engine_tokenizer(seed, dev, backend="host")[0]
    atok = engine_tokenizer(seed, dev, backend="auto",
                            tables=dtok._get_device().tables)[0]
    hi = host_inputs(seed, mb)
    allowed = set(specials)
    src = hi["text"] + multiscript(max(AUTO_SIZES), seed + 41)
    probe_ms = atok._device_dispatch_ms()
    warm = _prefix(src, 1 << 16)
    for tk in (ntok, dtok, atok):      # builds the engines, outside walls
        tk.encode(warm, allowed_special="all")
        tk.encode_batch(hi["texts"][:64], allowed_special="all")
    print(f"auto: dispatch probe {probe_ms:.4f} ms; constants "
          f"_DEVICE_MIN_BYTES {Tokenizer._DEVICE_MIN_BYTES}, "
          f"_DEVICE_AUTO_MIN_BYTES {Tokenizer._DEVICE_AUTO_MIN_BYTES}, "
          f"_DEVICE_HEALTHY_MS {Tokenizer._DEVICE_HEALTHY_MS}; set-up "
          f"{time.perf_counter() - t:.1f} s")
    counters = engine_counters()
    kinds = ("text", "batch", "ordinary batch")

    def calls(kind, size):
        """(callables by tokenizer, the host engine's ids and wall (s, or
        None), bytes)."""
        if kind == "text":
            x = _prefix(src, size)
            t = time.perf_counter()
            want = host.encode(x, allowed)[0]
            host_s = time.perf_counter() - t
            return ({tk: functools.partial(tk.encode, x,
                                           allowed_special="all")
                     for tk in (ntok, dtok, atok)}, want, host_s,
                    len(x.encode()))
        ordinary = kind == "ordinary batch"
        xs, want, nb = _batch_of(
            hi["texts"], hi["want_o" if ordinary else "want_b"], size)
        host_s = None
        if nb <= AUTO_HOST_MAX:
            t = time.perf_counter()
            for x in xs:
                (host.encode_ordinary(x) if ordinary
                 else host.encode(x, allowed))
            host_s = time.perf_counter() - t
        if ordinary:
            return ({tk: functools.partial(tk.encode_ordinary_batch, xs)
                     for tk in (ntok, dtok, atok)}, want, host_s, nb)
        return ({tk: functools.partial(tk.encode_batch, xs,
                                       allowed_special="all")
                 for tk in (ntok, dtok, atok)}, want, host_s, nb)

    def drive():
        rows = {}
        for kind in kinds:
            for size in AUTO_SIZES:
                fns, want, host_s, nb = calls(kind, size)
                walls = {ntok: [], dtok: []}
                for tk in (ntok, dtok, dtok, ntok):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    got = fns[tk]()
                    walls[tk].append(time.perf_counter() - t)
                    if got != want:
                        raise AssertionError(f"auto {kind} {size}: "
                                             f"{tk.backend} ids differ from "
                                             "the host engine")
                choice = atok._use_device(nb)
                rule = (nb >= Tokenizer._DEVICE_MIN_BYTES
                        and nb >= Tokenizer._DEVICE_AUTO_MIN_BYTES
                        and probe_ms < Tokenizer._DEVICE_HEALTHY_MS)
                t = time.perf_counter()
                got = fns[atok]()
                auto_s = time.perf_counter() - t
                if got != want or choice != rule:
                    raise AssertionError(f"auto {kind} {size}: ids differ "
                                         f"or the choice {choice} breaks "
                                         f"the rule {rule}")
                rows[(kind, size)] = (nb, min(walls[ntok]),
                                      min(walls[dtok]), host_s, choice,
                                      auto_s)
        return rows

    rows, wall, launches = count_runs(counters, drive)
    for kind in kinds:
        table = [rows[(kind, s)] for s in AUTO_SIZES]
        for nb, n_s, d_s, h_s, choice, a_s in table:
            py = (f", HostEngine {h_s * 1e3:.3f} ms "
                  f"({nb / 1e6 / h_s:.2f} MB/s)" if h_s else "")
            print(f"auto {kind} {nb} B: native {n_s * 1e3:.3f} ms "
                  f"({nb / 1e6 / n_s:.2f} MB/s), device {d_s * 1e3:.3f} ms "
                  f"({nb / 1e6 / d_s:.2f} MB/s){py}; auto chose "
                  f"{'device' if choice else 'native'} "
                  f"({a_s * 1e3:.3f} ms)")
        sizes = [r[0] for r in table]
        devs = [r[2] for r in table]
        vs_native = _crossover(sizes, devs, [r[1] for r in table])
        vs_host = _crossover(sizes, devs, [r[3] for r in table])
        print(f"auto {kind}: crossover against the native engine "
              + (f"{vs_native} B" if vs_native else "none up to 16 MB")
              + "; against HostEngine "
              + (f"{vs_host} B" if vs_host else "none where measured"))
    print(f"auto: every id equals the host engine's; phase {wall:.1f} s; "
          f"launches {json.dumps(launches)}")
    dead = [n for n in CORPUS_KERNELS if not launches[n]]
    if dev != "cpu" and dead:
        raise AssertionError(f"auto: kernels never launched: {dead}")
    return launches


# ===========================================================================
# The device BPE merge: the kernel, the piece path, miss_mode="device"
# ===========================================================================

MERGE_SHAPES = (("piece", 8192, 16), ("piece", 8192, 64),
                ("piece", 8192, 256), ("window", 262144, 16),
                ("window", 32768, 64), ("window", 4096, 256),
                ("mesh", 262144, 64), ("mesh", 131072, 64))
# edge calls: R = 1, one row past a block (8 rows at 32 lanes a row, 32 at
# 8, 64 at 4) and both sides of the lane-count steps (csrc/merge.cu); rows
# over 64 bytes always take 32 lanes, so they take the first two only
MERGE_EDGE_ROWS = (1, 9, 2048, 2049, 4097, 8192, 8193, 8257)
MERGE_EDGE_WIDTHS = (1, 3, 16, 17, 64, 65, 100, 256)

@functools.lru_cache(maxsize=None)
def l2_read_ns(dev) -> float:
    """One dependent L2 read (ns), measured once by a pointer chase."""
    from tokendagger_tpu_torch.ops import merge as M

    ns = M.l2_chase_ns(device=dev)
    print(f"merge: one dependent L2 read {ns:.1f} ns (pointer chase over "
          "a 4 MB table)")
    return ns


def merge_rows_input(seed: int, R: int, W: int, dev):
    """(R, W) uint8 merge rows and (R,) int32 lengths on ``dev``: edge rows
    first (lengths 0, 1 and W; runs of one byte, whose equal pairs tie;
    bytes >= 0x80, most of whose pairs have no rank; random bytes of every
    value), then seeded random printable ASCII, which the stand-in
    vocabulary's random tokens merge the most, half of the rows W long."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(32, 127, (R, W)).astype(np.uint8)
    lens = np.where(rng.random(R) < 0.5, W,
                    rng.integers(1, W + 1, R)).astype(np.int32)
    edge = [b"", b"a", b"a" * W, b" " * W, b"e" * W, b"-" * W,
            bytes(rng.integers(0x80, 0x100, W).astype(np.uint8)),
            bytes(rng.integers(0, 0x100, W).astype(np.uint8))]
    for r, row in enumerate(edge):
        buf[r] = rng.integers(0, 256, W)           # garbage past the length
        buf[r, : len(row)] = np.frombuffer(row, np.uint8)
        lens[r] = len(row)
    return torch.from_numpy(buf).to(dev), torch.from_numpy(lens).to(dev)


def merge_cost(ln, counts, W: int, lut: bool) -> tuple[int, int, int, int]:
    """The merge's bound inputs for rows of width W with lengths ``ln``
    that end with ``counts`` tokens: bytes (rows and lengths read, ids
    and counts written, a 48-byte pair row per lookup, two per merge; the
    first round reads the lut's 4 bytes a pair, or a row a pair), ops (a
    scan of the row per merge), the merges and the longest row's."""
    R = ln.shape[0]
    merges = (ln.to(torch.int64) - counts).clamp(min=0)
    n_merges = int(merges.sum())
    pairs = int((ln.to(torch.int64) - 1).clamp(min=0).sum())
    n_bytes = (5 * R * W + 8 * R + 96 * n_merges
               + pairs * (4 if lut else 48))
    return n_bytes, n_merges * W, n_merges, int(merges.max()) if R else 0


def merge_timings(args, label: str) -> dict:
    """The merge kernel's timings (``timings``) on the wrapper's arguments
    ``args``, with its bytes bound, its latency floor (the longest row's
    merges times one dependent L2 read) and the lanes it gives a row;
    fails unless the kernel equals the plain loop."""
    from tokendagger_tpu_torch.ops import merge as M

    by, ln, br, rows, mask, lut = args

    def fn():
        return M.merge_rows(by, ln, br, rows, mask, lut)

    def plain():
        return M.merge_rows_local(by, ln, br, rows, mask=mask, pair_lut=lut)

    R, W = by.shape
    want = plain()
    if max_abs_err(fn(), want):
        raise AssertionError(f"merge {label}: the kernel differs from the "
                             "plain loop")
    n_bytes, n_ops, n_merges, longest = merge_cost(ln, want[1], W,
                                                   lut is not None)
    t = timings(fn, plain, n_bytes, n_ops, plain_reps=3)
    t["ms"] = min(t["ms"], device_ms(fn))
    t.update(merges=n_merges, longest_row_merges=longest,
             latency_floor_ms=longest * l2_read_ns(by.device.type) * 1e-6,
             lanes_per_row=M.lanes_per_row(R, W))
    print(f"merge [{label}]: {show(t)}; "
          f"{t['lanes_per_row']} lanes a row; {n_merges} merges, longest row "
          f"{longest}: latency floor {t['latency_floor_ms']:.4f} ms")
    return t


def chain_vocab(seed: int) -> tuple[dict[bytes, int], bytes]:
    """Ranks over all 256 bytes, every run of 2-256 b"a" and every prefix of
    a seeded 256-byte string S without b"a", whose adjacent pairs but the
    first are no tokens: rows of W b"a" and S[:W] merge W - 1 times into
    one token. Returns (ranks, S)."""
    rng = np.random.default_rng(seed)
    chars = [c for c in range(33, 127) if c != ord("a")]
    s = bytes(rng.choice(chars, 256).astype(np.uint8))
    ranks = {bytes([i]): i for i in range(256)}
    for k in range(2, 257):
        ranks[b"a" * k] = len(ranks)
    for k in range(2, 257):
        ranks[s[:k]] = len(ranks)
    return ranks, s


def merge_edge_rows(seed: int, R: int, W: int, chain: bytes, dev):
    """(R, W) rows cycling through: empty, random of length W, one byte,
    random of length W, S[:W], W b"a", W spaces, random of length 1..W;
    garbage bytes past each length."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, (R, W)).astype(np.uint8)
    lens = np.zeros(R, np.int32)
    for r in range(R):
        k = r % 8
        row = (b"" if k == 0 else b"a" if k == 2 else chain[:W] if k == 4
               else b"a" * W if k == 5 else b" " * W if k == 6
               else bytes(rng.integers(32, 127, W if k in (1, 3)
                                       else int(rng.integers(1, W + 1)))
                          .astype(np.uint8)))
        buf[r, : len(row)] = np.frombuffer(row, np.uint8)
        lens[r] = len(row)
    return torch.from_numpy(buf).to(dev), torch.from_numpy(lens).to(dev)


def check_merge_edges(seed: int, dev, mt) -> int:
    """The merge kernel against the plain loop on edge calls: R in
    MERGE_EDGE_ROWS x the widths MERGE_EDGE_WIDTHS (16, 64, 256 and
    others; over 64 bytes R = 1 and 9), with and without pair_lut, on the stand-in's tables and a
    chain vocabulary's (``chain_vocab``: its S[:W] and W b"a" rows merge
    W - 1 times); each call must launch once. Returns the largest
    error."""
    from tokendagger_tpu_torch.convert import merge_tables_from_ranks
    from tokendagger_tpu_torch.ops import merge as M

    ranks, chain = chain_vocab(seed)
    vocabs = (("stand-in", mt),
              ("chain", merge_tables_from_ranks(ranks, device=dev)))
    t, err, calls = time.perf_counter(), 0, 0
    for name, tb in vocabs:
        for W in MERGE_EDGE_WIDTHS:
            for R in MERGE_EDGE_ROWS if W <= 64 else MERGE_EDGE_ROWS[:2]:
                by, ln = merge_edge_rows(seed + R + W, R, W, chain, dev)
                for lut in (None, tb.pair_lut):
                    n0 = M.merge_rows.launches
                    got = M.merge_rows(by, ln, tb.byte_rank, tb.pair_rows,
                                       tb.pair_mask, lut)
                    if M.merge_rows.launches != n0 + 1:
                        raise AssertionError("merge: a call did not count "
                                             "one launch")
                    want = M.merge_rows_local(by, ln, tb.byte_rank,
                                              tb.pair_rows, mask=tb.pair_mask,
                                              pair_lut=lut)
                    e = max_abs_err(got, want)
                    if e:
                        raise AssertionError(
                            f"merge kernel differs on edge rows {(R, W)} "
                            f"({name}, pair_lut {lut is not None})")
                    if name == "chain" and R > 5 and W > 1 and (
                            int(want[1][4]) != 1 or int(want[1][5]) != 1):
                        raise AssertionError("merge: the chain rows did not "
                                             "merge into one token")
                    err, calls = max(err, e), calls + 1
    print(f"merge kernel: edge rows exact in {calls} calls (R {MERGE_EDGE_ROWS}"
          f" x W {MERGE_EDGE_WIDTHS}, over 64 bytes R 1 and 9; both "
          "vocabularies, with and without "
          f"pair_lut; chains of W - 1 merges) in "
          f"{time.perf_counter() - t:.1f} s")
    return err


def check_merge_kernel(seed: int, dev, mt) -> dict:
    """The merge kernel against the plain loop on the card at MERGE_SHAPES
    (the piece path's 8,192 rows of 16, 64 and 256 bytes, resolve_window's
    4 MB bucket caps, the mesh steps' and the sharded text's rows) on
    seeded rows, with and without pair_lut, and on the edge calls
    (``check_merge_edges``); times each shape as its path calls it (the
    windows with pair_lut). Returns the kernels-line row."""
    from tokendagger_tpu_torch.ops import merge as M

    err, times = check_merge_edges(seed, dev, mt), {}
    for i, (path, R, W) in enumerate(MERGE_SHAPES):
        by, ln = merge_rows_input(seed + i, R, W, dev)
        for lut in (None, mt.pair_lut):
            got = M.merge_rows(by, ln, mt.byte_rank, mt.pair_rows,
                               mt.pair_mask, lut)
            want = M.merge_rows_local(by, ln, mt.byte_rank, mt.pair_rows,
                                      mask=mt.pair_mask, pair_lut=lut)
            e = max_abs_err(got, want)
            err = max(err, e)
            if e:
                raise AssertionError(f"merge kernel differs at {(R, W)} "
                                     f"(pair_lut {lut is not None})")
        lut = mt.pair_lut if path == "window" else None
        key = f"{path} ({R}, {W})" + (" pair_lut" if lut is not None else "")
        times[key] = merge_timings(
            (by, ln, mt.byte_rank, mt.pair_rows, mt.pair_mask, lut), key)
    print(f"merge kernel: max_abs_err {err} at {len(MERGE_SHAPES)} shapes x "
          "2 (with and without pair_lut), edge rows included")
    head = next(iter(times))
    return dict(name="merge", route="cuda",
                source="tokendagger_tpu_torch/csrc/merge.cu",
                replaces="tokendagger_tpu/ops/merge.py:96 (XLA while_loop, "
                         "no pallas_call)",
                max_abs_err=err, **{k: times[head][k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "latency_floor_ms")},
                library_ms=None, l2_read_ns=l2_read_ns(dev),
                **by_shape(times))


def rare_text(seed: int, n_bytes: int) -> str:
    """About n_bytes of multi-script text with a seeded rare lowercase
    identifier of 2-256 bytes (log-uniform) about every 2 KB, and eight of
    300-600 bytes: misses for every merge width and oversize pieces."""
    rng = np.random.default_rng(seed)
    base = multiscript(n_bytes, seed + 1)
    k = len(base) // 2048
    cuts = np.sort(rng.integers(0, len(base), k)).tolist()
    lens = np.exp(rng.uniform(np.log(2), np.log(256), k)).astype(int)
    lens[rng.choice(k, 8, replace=False)] = rng.integers(300, 601, 8)
    parts, prev = [], 0
    for c, n in zip(cuts, lens.tolist()):
        word = "".join(chr(x) for x in rng.integers(97, 123, n))
        parts += [base[prev:c], " ", word, " "]
        prev = c
    return "".join(parts + [base[prev:]])


def run_pieces(seed: int, dev, n_bytes: int = 9 << 19
               ) -> tuple[dict | None, dict, dict]:
    """The device merge on the engine phase's stand-in vocabulary: its
    kernel at every shape (``check_merge_kernel``); the piece path
    (``DeviceEngine(stream=False)``) over 4.5 MB of multi-script text with
    rare identifiers, with vocab_fastpath True and False and with a copy
    of the vocabulary without b"\xff"; then miss_mode="device" windows of
    the same text with the probe and with the sort join. Every run's ids
    must equal the host engine's. Returns the kernels-line row, and the
    launches of the piece path and of the device-merge windows."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine, HostEngine
    from tokendagger_tpu_torch.convert import merge_tables_from_ranks
    from tokendagger_tpu_torch.ops import merge as M

    t = time.perf_counter()
    tok, host, specials = engine_tokenizer(seed, dev)
    ranks = tok._mergeable_ranks
    tables = tok._get_device().tables
    mt = merge_tables_from_ranks(ranks, device=dev)
    nb_card = sum(x.numel() * x.element_size() for x in (
        mt.byte_rank, mt.pair_rows, mt.pair_lut, mt.vk, mt.vlen, mt.vrank))
    print(f"pieces: merge tables of {len(ranks)} ranks: pair table "
          f"{mt.pair_rows.shape[0]} buckets ({mt.pair_rows.numel() * 4} B), "
          f"{nb_card} B on the card in all, built in "
          f"{time.perf_counter() - t:.1f} s (with the tokenizer)")
    row = check_merge_kernel(seed + 60, dev, mt) if dev != "cpu" else None

    text = rare_text(seed + 61, n_bytes)
    nbytes = len(text.encode())
    t = time.perf_counter()
    want = host.encode_ordinary(text)
    pieces = {text[a:b].encode() for a, b in host.split_spans(text)}
    n_multi = sum(1 < len(p) <= 256 for p in pieces)
    print(f"pieces: text {nbytes} B, {len(pieces)} unique pieces "
          f"({n_multi} of 2-256 bytes), host ids in "
          f"{time.perf_counter() - t:.1f} s")
    counters = {"merge": M.merge_rows}
    launches: dict = {}
    no_ff = {b: r for b, r in ranks.items() if b != b"\xff"}
    runs = (("vocab_fastpath=True", ranks, True),
            ("vocab_fastpath=False", ranks, False),
            ('without b"\\xff"', no_ff, True))
    for label, rk, fast in runs:
        eng = DeviceEngine(LLAMA4_PATTERN, rk, specials, device=dev,
                           vocab_fastpath=fast,
                           stream=False if rk is ranks else None,
                           tables=tables if rk is ranks else None)
        if eng.stream:
            raise AssertionError("a vocabulary without a byte rank took the "
                                 "stream path")
        eng.encode_ordinary_batch([text[: 1 << 16]])   # warm-up, tables
        eng.stats = type(eng.stats)()
        ids, wall, n = count_runs(
            counters, lambda: eng.encode_ordinary_batch([text])[0])
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        st = eng.stats
        rows = dict(sorted(st.merge_rows_by_width.items()))
        print(f"pieces {label}: {nbytes} B in {wall:.4f} s = "
              f"{nbytes / 1e6 / wall:.2f} MB/s wall; merge rows by width "
              f"{json.dumps(rows)}, {n['merge']} merge launches, merge "
              f"time {st.merge_s:.4f} s")
        if dev != "cpu" and n["merge"] == 0:
            raise AssertionError(f"pieces {label}: the merge never launched")
        if not fast and sum(rows.values()) != n_multi:
            raise AssertionError(f"pieces {label}: {sum(rows.values())} "
                                 f"rows merged, not the {n_multi} unique "
                                 "multi-byte pieces")
        want_here = want if rk is ranks else HostEngine(
            LLAMA4_PATTERN, rk, specials).encode_ordinary(text)
        if ids != want_here:
            raise AssertionError(f"pieces {label}: ids differ from the host "
                                 f"engine at id {first_diff(ids, want_here)}")
    print("pieces: every piece-path run equals the host engine "
          f"({len(want)} ids)")

    # miss_mode="device" windows of the same text
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device=dev,
                       tables=tables)
    eng.miss_mode = "device"
    counters = {**engine_counters(), "merge": M.merge_rows}
    window_launches: dict = {}
    for join in ("probe", "sort"):
        eng.join_mode = join
        eng.encode_stream(text.encode()[: 1 << 20])      # warm-up
        eng.stats = type(eng.stats)()
        ids, wall, n = count_runs(
            counters, lambda: eng.encode_stream(text.encode()).tolist())
        for k, v in n.items():
            window_launches[k] = window_launches.get(k, 0) + v
        st = eng.stats
        rows = dict(sorted(st.merge_rows_by_width.items()))
        print(f"window miss_mode=device join_mode={join}: {nbytes} B in "
              f"{wall:.4f} s = {nbytes / 1e6 / wall:.2f} MB/s wall; "
              f"{st.windows} windows ({st.cut_windows} cut), "
              f"{st.host_advance_windows} overflow; merge rows by width "
              f"{json.dumps(rows)}; {st.spliced_pieces} pieces over 256 B "
              f"spliced; stage times (host clock, s): safe_cut "
              f"{st.safe_cut_s:.4f}, device {st.device_s:.4f}, drain "
              f"{st.drain_s:.4f}; launches {json.dumps(n)}")
        dead = [k for k, v in n.items() if not v and k != "piece_starts_rows"
                and not (join == "sort" and k == "vocab_probe8")]
        if (dev != "cpu" and dead) or st.host_advance_windows:
            raise AssertionError(f"window {join}: kernels never launched "
                                 f"{dead}, or a window overflowed")
        if sorted(rows) != [16, 64, 256] or not all(rows.values()) or (
                not st.spliced_pieces):
            raise AssertionError(f"window {join}: a merge width got no row "
                                 f"({rows}) or no oversize piece was "
                                 "spliced")
        if ids != want:
            raise AssertionError(f"window {join}: ids differ from the host "
                                 f"engine at id {first_diff(ids, want)}")
    print("window miss_mode=device: both joins equal the host engine")
    if dev != "cpu":
        win = text.encode()[:ENGINE_WINDOW]
        trim = eng._safe_cut_threshold(win)
        data = torch.from_numpy(np.frombuffer(win, np.uint8).copy())[None]
        data, nb = data.to(dev), torch.tensor([len(win)], dtype=torch.int32,
                                              device=dev)
        ms = {}
        for miss, join in (("host", "probe"), ("device", "probe"),
                           ("device", "sort")):
            eng.miss_mode, eng.join_mode = miss, join
            ms[f"{miss}/{join}"] = median_ms(
                lambda: eng.window_pipeline(data, nb, trim), reps=5)
        print("window pipeline, one 4 MB window (synchronized call, ms): "
              + ", ".join(f"miss_mode/join_mode {k} {v:.4f}"
                          for k, v in ms.items()))
    return row, launches, window_launches


# ===========================================================================
# run_resident's single-window pipeline, the other batched formulations,
# the char-form starts and the sort formulations beside the kernels
# ===========================================================================

# (label, text, run_resident arguments, impl expected, kernels that must
# launch in the run)
SINGLE_RUNS = (
    ("auto", "multiscript", {}, "sort", ("piece_starts_cp", "vocab_probe8")),
    ("ascii auto", "ascii", {}, "ascii-sort",
     ("piece_starts_cp", "vocab_probe8")),
    ("scatter", "multiscript", dict(impl="scatter"), "scatter",
     ("utf8_decode_block", "piece_starts_cp", "compact_by_mask",
      "vocab_probe8")),
    ("device/probe", "multiscript", dict(miss_mode="device"), "sort",
     ("piece_starts_cp", "compact_piece_keys", "compact_by_mask", "merge",
      "vocab_probe8")),
    ("device/sort", "multiscript", dict(miss_mode="device",
                                        join_mode="sort"), "sort",
     ("piece_starts_cp", "compact_piece_keys", "compact_by_mask", "merge")),
)
# the batched formulations: (impl, starts_impl) with compact_impl="sort"
FORMULATIONS = (("sort", "jnp", ("vocab_probe8",)),
                ("sort", "bits", ("piece_starts_cp", "vocab_probe8")),
                ("scatter", "jnp", ("utf8_decode_block", "compact_by_mask",
                                    "vocab_probe8")),
                ("scatter", "bits", ("utf8_decode_block", "piece_starts_cp",
                                     "compact_by_mask", "vocab_probe8")))


def single_counters():
    from tokendagger_tpu_torch.ops import merge as M

    c = resident_counters()
    return dict(utf8_decode_block=c["utf8_decode_block"],
                piece_starts_cp=c["piece_starts_cp"],
                compact_piece_keys=c["compact_piece_keys"],
                compact_by_mask=c["compact_by_mask"], merge=M.merge_rows,
                vocab_probe8=c["vocab_probe8"])


def single_texts(seed: int) -> dict:
    """The resident phase's multi-script corpus and the stream phase's
    ASCII generator, 9 MB each."""
    return {"multiscript": multiscript(9 * WINDOW, seed + 9).encode(),
            "ascii": corpus(9 * WINDOW, seed + 3).encode()}


def show_run(label: str, r, wall_s: float) -> None:
    print(f"{label}: impl {r.impl}, starts_impl {r.starts_impl}, "
          f"compact_impl {r.compact_impl}, probe_impl {r.probe_impl}, "
          f"match_host {r.match_host}, overflow_windows "
          f"{r.overflow_windows}, total_tokens {r.total_tokens}, "
          f"{wall_s:.1f} s")
    print(f"{label}: kernel_mbps {r.kernel_mbps}, device_ms {r.device_ms}, "
          f"wall_mbps {r.wall_mbps} (wall_ms {r.wall_ms})")
    show_trace(label, r)


def show_trace(label: str, r, quiet: bool = False) -> None:
    """A run_resident result's device stage times (summed kernel, copy and
    memset durations from its profiler trace) beside its CUDA-event stage
    times, and the trace's kernel events beside the wrappers' launches;
    fails if the trace lost a kernel event or timed no stage."""
    if not quiet:
        print(f"{label}: device stage_us (trace) {json.dumps(r.stage_us)}; "
              f"event stage_us {json.dumps(r.event_us)}; device_ms "
              f"{r.device_ms} vs event_ms {r.event_ms}")
        print(f"{label}: trace kernel events / launches "
              + json.dumps({k: f"{v['events']}/{v['launches']}"
                            for k, v in r.trace_kernels.items()})
              + f", shortfall {json.dumps(r.trace_kernel_shortfall)}")
    if r.trace_kernel_shortfall or not r.stage_us:
        raise AssertionError(f"{label}: the profiler trace lost kernel "
                             f"events or timed no stage: "
                             f"{r.trace_kernel_shortfall}, {r.stage_us}")


def run_single_phase(seed: int, dev, *, reps: int = 20,
                     n_ranks=200_000) -> tuple[dict, dict]:
    """run_resident(batch=1) at full width: 8 windows of 1 MB, one a
    repetition, cycled 20 times, with the resident phase's stand-in
    vocabulary: multi-script text (auto gives "sort"), ASCII text (auto
    gives "ascii-sort"), impl="scatter", and miss_mode="device" with the
    probe and the sort joins. Each run's ids must equal the host engine's
    with no overflow, and each run's kernels must launch (counts set to 0
    just before it). The timed run checks window 0 against the host
    engine and reads the overflow of its last repetition's window, so
    each window then runs alone once (untimed, uncounted) and must equal
    the host engine with no overflow. Returns the path's launches,
    summed, and by run the arguments of each kernel's first launch at
    each shape."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, run_resident

    ranks = standin_vocab(n_ranks, seed, extra=multiscript(1 << 20,
                                                          seed + 4))
    texts = single_texts(seed)
    counters = single_counters()
    launches = dict.fromkeys(counters, 0)
    inputs: dict = {}
    for label, text, kw, impl, need in SINGLE_RUNS:
        for k in counters.values():
            k.launches = 0
        t = time.perf_counter()
        with recorded_inputs() as inputs[f"single {label}"]:
            r = run_resident(ranks, {}, LLAMA4_PATTERN, texts[text],
                             window=WINDOW, n_windows=BATCH, reps=reps,
                             device=dev, **kw)
        run = {n: k.launches for n, k in counters.items()}
        show_run(f"single {label}", r, time.perf_counter() - t)
        print(f"single {label}: launches {json.dumps(run)}")
        if not (r.match_host and r.overflow_windows == 0 and r.impl == impl
                and r.batch == 1 and r.starts_impl == "jnp"
                and r.compact_impl == "sort"):
            raise AssertionError(f"single {label}: ids differ from the host "
                                 "engine, a window overflowed, or the run "
                                 "took another pipeline")
        dead = [n for n in need if run[n] == 0]
        if dead:
            raise AssertionError(f"single {label}: kernels never launched: "
                                 f"{dead}")
        for n, v in run.items():
            launches[n] += v
        # window w of the timed run is the first window of the text from
        # byte w * WINDOW on
        t = time.perf_counter()
        tokens = []
        for w in range(BATCH):
            c = run_resident(ranks, {}, LLAMA4_PATTERN,
                             texts[text][w * WINDOW :], window=WINDOW,
                             n_windows=1, reps=1, overlap_trial=False,
                             device=dev, **kw)
            if not (c.match_host and c.overflow_windows == 0
                    and c.impl == impl):
                raise AssertionError(f"single {label}: window {w} alone "
                                     "differs from the host engine or "
                                     "overflowed")
            show_trace(f"single {label} window {w}", c, quiet=True)
            tokens.append(c.total_tokens)
        print(f"single {label}: each of the {BATCH} windows alone equals "
              f"the host engine, 0 overflowed (tokens {tokens}), "
              f"{time.perf_counter() - t:.1f} s")
    return launches, inputs


def run_formulations(seed: int, dev, *, reps: int = 5,
                     n_ranks=200_000) -> tuple[dict, dict]:
    """run_resident's batched formulations at 8 x 1 MB of the multi-script
    text: impl "sort" and "scatter" x starts_impl "jnp" (the char form in
    plain torch) and "bits" (K1), compact_impl "sort". Ids of every
    window equal to the host engine, no window overflowed, each run's
    kernels launched. Returns the path's launches, summed, and by run
    the arguments of each kernel's first launch at each shape."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, run_resident

    ranks = standin_vocab(n_ranks, seed, extra=multiscript(1 << 20,
                                                          seed + 4))
    text = single_texts(seed)["multiscript"]
    counters = single_counters()
    launches = dict.fromkeys(counters, 0)
    inputs: dict = {}
    for impl, starts_impl, need in FORMULATIONS:
        for k in counters.values():
            k.launches = 0
        label = f"formulation {impl}/{starts_impl}"
        t = time.perf_counter()
        with recorded_inputs() as inputs[label]:
            r = run_resident(ranks, {}, LLAMA4_PATTERN, text, window=WINDOW,
                             n_windows=BATCH, batch=BATCH, reps=reps,
                             impl=impl, starts_impl=starts_impl,
                             compact_impl="sort", overlap_trial=False,
                             device=dev)
        run = {n: k.launches for n, k in counters.items()}
        show_run(label, r, time.perf_counter() - t)
        print(f"{label}: launches {json.dumps(run)}")
        if not (r.match_host and r.overflow_windows == 0 and r.impl == impl
                and r.starts_impl == starts_impl
                and r.compact_impl == "sort"):
            raise AssertionError(f"{label}: ids differ from the host engine, "
                                 "a window overflowed, or the run took "
                                 "another pipeline")
        dead = [n for n in need if run[n] == 0]
        if dead:
            raise AssertionError(f"{label}: kernels never launched: {dead}")
        for n, v in run.items():
            launches[n] += v
    return launches, inputs


def resident_windows(seed: int, dev):
    """The 8 char-aligned 1 MB windows of the multi-script text on the
    card, as run_resident stages them, and their lengths."""
    from tokendagger_tpu_torch.utils.windows import char_align

    text = single_texts(seed)["multiscript"]
    by = np.zeros((BATCH, WINDOW), np.uint8)
    nb = np.zeros(BATCH, np.int32)
    for w in range(BATCH):
        lo = (w * WINDOW) % max(1, len(text) - WINDOW)
        arr = char_align(np.frombuffer(text[lo : lo + WINDOW], np.uint8))
        by[w, : len(arr)] = arr
        nb[w] = len(arr)
    return torch.from_numpy(by).to(dev), torch.from_numpy(nb).to(dev)


def check_char_forms(seed: int, dev) -> tuple[int, dict]:
    """The char-form starts (``pretokenize.piece_starts``, plain torch on
    the card) and ``match_lengths`` + ``chain_starts`` against K1's
    codepoint entry at (8, 1 M) chars of the resident windows, for the
    four profiles; the flags must be equal. Prints each one's
    synchronized call time beside K1's. Returns the largest difference
    and K1's time by profile."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import pretokenize as PT
    from tokendagger_tpu_torch.unicode_tables import get_two_level_tables

    d, nb = resident_windows(seed, dev)
    cp, _, _, m = PT.utf8_decode(d, nb)
    page_ids, pages = (torch.from_numpy(a.astype(np.int64)).to(dev)
                       for a in get_two_level_tables())
    err, times = 0, {}
    for profile in ("llama4", "nocontract", "cl100k", "gpt2"):
        k1 = BP.piece_starts_chars(cp, m, profile=profile)
        char = PT.piece_starts(cp, m, page_ids, pages, profile=profile)
        chain = PT.chain_starts(PT.match_lengths(
            cp, m, page_ids, pages, profile=profile), m)
        e = max(max_abs_err([char.to(torch.int32)], [k1.to(torch.int32)]),
                max_abs_err([chain.to(torch.int32)], [k1.to(torch.int32)]))
        t = dict(
            k1_ms=median_ms(lambda: BP.piece_starts_chars(
                cp, m, profile=profile), reps=5),
            char_ms=median_ms(lambda: PT.piece_starts(
                cp, m, page_ids, pages, profile=profile), reps=3, warmup=1),
            chain_ms=median_ms(lambda: PT.chain_starts(PT.match_lengths(
                cp, m, page_ids, pages, profile=profile), m), reps=3,
                warmup=1))
        print(f"char forms {profile} at {tuple(cp.shape)}: "
              f"{int(k1.sum())} starts, max_abs_err {e} against K1's "
              f"codepoint entry; synchronized call ms: K1 "
              f"{t['k1_ms']:.4f}, char form {t['char_ms']:.4f}, "
              f"match_lengths + chain_starts {t['chain_ms']:.4f}")
        if e:
            raise AssertionError(f"char forms {profile}: flags differ from "
                                 "K1's codepoint entry")
        err = max(err, e)
        times[profile] = t
    return err, times


def time_sort_formulations(seed: int, dev) -> dict:
    """The sort formulations beside the kernels that compute the same
    contract, on one 1 MB window of the multi-script text: outputs equal,
    then device-only ms and synchronized call ms of each:
    ``utf8_decode_sorted`` vs ``utf8_decode`` (K9 + K4),
    ``join.compact_piece_keys_sorted`` vs ``compact.compact_piece_keys``
    (K2+K3), ``fused.finalize_host_sorted`` vs ``compact.finalize`` (K4)."""
    from tokendagger_tpu_torch.convert import tables_from_ranks
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import fused as FU
    from tokendagger_tpu_torch.ops import join as J
    from tokendagger_tpu_torch.ops import pretokenize as PT
    from tokendagger_tpu_torch.unicode_tables import get_two_level_tables

    d8, nb8 = resident_windows(seed, dev)
    d, nb = d8[:1].contiguous(), nb8[:1].contiguous()
    N = d.shape[1]
    p_cap = FU.caps_for(N)["p_cap"]
    ranks = standin_vocab(200_000, seed, extra=multiscript(1 << 20,
                                                          seed + 4))
    tables = tables_from_ranks(ranks, device=dev)
    cp, cob, boc, m = PT.utf8_decode(d, nb)
    stb = PT.starts_to_bytes(PT.compute_starts(cp, m, *get_two_level_tables()),
                             cob, d, nb)
    sb, pl, k0, k1, k2, k3, npc = CP.compact_piece_keys(stb, d, nb, p_cap)
    rank = J.vocab_probe8(k0, k1, k2, k3, pl, tables.vhash8_rows,
                          tables.vhash8_mask)
    pairs = {
        "decode": (lambda: PT.utf8_decode_sorted(d, nb),
                   lambda: PT.utf8_decode(d, nb),
                   "utf8_decode_sorted", "utf8_decode (K9 + K4)"),
        "keys": (lambda: J.compact_piece_keys_sorted(stb, d, nb, p_cap),
                 lambda: CP.compact_piece_keys(stb, d, nb, p_cap),
                 "join.compact_piece_keys_sorted",
                 "compact.compact_piece_keys (K2+K3)"),
        "finalize": (lambda: FU.finalize_host_sorted(
            sb, pl, rank, npc, N, p_cap=p_cap, untrimmed=True),
            lambda: CP.finalize(sb, pl, rank, npc, p_cap=p_cap),
            "fused.finalize_host_sorted", "compact.finalize (K4)"),
    }
    out = {}
    for stage, (sorted_fn, kernel_fn, sname, kname) in pairs.items():
        a = [x.to(torch.int64) for x in sorted_fn()]
        b = [x.to(torch.int64) for x in kernel_fn()]
        e = max_abs_err(a, b)
        if e:
            raise AssertionError(f"sort formulation {stage}: {sname} and "
                                 f"{kname} differ")
        t = dict(sorted_ms=device_ms(sorted_fn),
                 sorted_call_ms=median_ms(sorted_fn),
                 kernel_ms=device_ms(kernel_fn),
                 kernel_call_ms=median_ms(kernel_fn))
        print(f"sort formulation {stage}, one 1 MB window ({int(npc[0])} "
              f"pieces): {sname} {t['sorted_ms']:.4f} ms on the device "
              f"({t['sorted_call_ms']:.4f} ms per synchronized call); "
              f"{kname} {t['kernel_ms']:.4f} ({t['kernel_call_ms']:.4f}); "
              "outputs equal")
        out[stage] = t
    return out

# ===========================================================================
# The mesh phase: parallel/ on torch.distributed
# ===========================================================================

MESH_ROWS, MESH_ROW_W = 262_144, 64     # the steps' packed pretoken rows
MESH_TEXT_MB = 16                       # the sharded text
MESH_PAIR_ROWS, MESH_PAIR_MB = 65_536, 4   # two ranks sharing the card
MESH_CANDIDATES = 450_000               # stand-in ranks before the audit


def mesh_counters():
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import join as J
    from tokendagger_tpu_torch.ops import merge as M
    from tokendagger_tpu_torch.ops import pretokenize as PT

    # K1's codepoint entry is not on the path: the sharded text finds its
    # starts by match lengths and pointer doubling (plain torch), and the
    # general mesh pipeline runs the hot-codepoint route (class words)
    return dict(utf8_decode_block=PT.utf8_decode_block,
                piece_starts=BP.piece_starts_bits,
                piece_starts_words=BP.piece_starts_words,
                compact_piece_keys=CP.compact_piece_keys,
                compact_by_mask=CP.compact_by_mask,
                compact_record=CP.compact_record,
                expand_route=CP.expand_route, merge=M.merge_rows,
                vocab_probe8=J.vocab_probe8)


def reachable_vocab(seed: int) -> dict[bytes, int]:
    """A merge-reachable stand-in: the 450,000-candidate stand-in (the
    engine phase's recipe at a larger count), its unreachable tokens
    dropped until the audit holds at a fixed point, renumbered densely in
    rank order (which keeps every merge's outcome)."""
    from tokendagger_tpu_torch.tables import unreachable

    t = time.perf_counter()
    ranks = dict(standin_vocab(MESH_CANDIDATES, seed,
                               extra=multiscript(1 << 20, seed + 4)))
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    rounds = 0
    while True:
        rounds += 1
        bad = list(unreachable(ranks))
        if not bad:
            break
        for tb in bad:
            del ranks[tb]
    ranks = {tb: i for i, tb in enumerate(sorted(ranks, key=ranks.get))}
    print(f"mesh: reachable stand-in {len(ranks)} ranks of "
          f"{MESH_CANDIDATES} candidates (audit to a fixed point in {rounds} "
          f"rounds, {time.perf_counter() - t:.1f} s; candidates "
          f"{build_s:.1f} s)")
    return ranks


def mesh_rows(text: str, ranks: dict, n_rows: int, width: int):
    """(buf (n_rows, width) uint8, lens, expected ids per row): the
    pretokens of at most ``width`` bytes of ``text``, in order, and each
    one's byte_pair_encode."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine
    from tokendagger_tpu_torch.hostengine import byte_pair_encode

    host = HostEngine(LLAMA4_PATTERN, ranks, {})
    pieces: list[bytes] = []
    pos = 0
    while len(pieces) < n_rows:
        chunk = text[pos : pos + (1 << 20)]
        if not chunk:
            raise AssertionError("the text holds too few pretokens")
        pos += len(chunk)
        for a, b in host.split_spans(chunk):
            p = chunk[a:b].encode()
            if len(p) <= width:
                pieces.append(p)
    pieces = pieces[:n_rows]
    buf = np.zeros((n_rows, width), np.uint8)
    lens = np.zeros(n_rows, np.int32)
    memo: dict[bytes, list[int]] = {}
    want = []
    for r, p in enumerate(pieces):
        buf[r, : len(p)] = np.frombuffer(p, np.uint8)
        lens[r] = len(p)
        if p not in memo:
            memo[p] = byte_pair_encode(p, ranks)
        want.append(memo[p])
    return buf, lens, want


def check_step(label: str, out, lens, want) -> None:
    """A step's (tok, counts, bytes, tokens) against the expected ids
    per row and the totals."""
    tok, counts, tb, tt = out
    flat = tok[tok >= 0].cpu().numpy()
    exp = np.fromiter((i for w in want for i in w), np.int64)
    n_want = np.asarray([len(w) for w in want])
    ok = (np.array_equal(counts.cpu().numpy(), n_want)
          and np.array_equal(flat, exp)
          and int(tb) == int(lens.sum()) and int(tt) == len(exp))
    print(f"mesh {label}: {len(want)} rows, tokens equal byte_pair_encode "
          f"{ok}; counters bytes {int(tb)}, tokens {int(tt)}")
    if not ok:
        raise AssertionError(f"mesh {label}: tokens or counters differ")


def hold_recorded(seen: dict, label: str) -> dict:
    """Every kernel against its plain version on the arguments of each
    recorded launch (``recorded_inputs``); returns each kernel's largest
    error and fails on any difference."""
    from tokendagger_tpu_torch.ops import bitplane as BP
    from tokendagger_tpu_torch.ops import compact as CP
    from tokendagger_tpu_torch.ops import join as J
    from tokendagger_tpu_torch.ops import merge as M
    from tokendagger_tpu_torch.ops import pretokenize as PT

    def pair(name, a):
        if name == "utf8_decode_block":
            return (PT.utf8_decode_block(*a), PT.utf8_decode_block_plain(*a))
        if name == "piece_starts":
            by, nb, prof = a
            return ([BP.piece_starts_bits(by, nb, profile=prof)],
                    [BP.piece_starts_bits_plain(by, nb, profile=prof)])
        if name == "piece_starts_cp":
            cp, m, prof = a
            return ([BP.piece_starts_chars(cp, m, profile=prof,
                                           packed_out=True)],
                    [BP.piece_starts_chars_plain(cp, m, profile=prof)])
        if name == "piece_starts_words":
            w, m, prof = a
            return ([BP.piece_starts_words(w, m, profile=prof)],
                    [BP.piece_starts_words_plain(w, m, profile=prof)])
        if name == "compact_piece_keys":
            st, d, nb, p_cap, packed = a
            return (CP.compact_piece_keys(st, d, nb, p_cap, packed=packed),
                    CP.compact_piece_keys_plain(st, d, nb, p_cap,
                                                packed=packed))
        if name == "compact_by_mask":
            arrays, mask, fill = a
            return (CP.compact_by_mask(arrays, mask, fill=fill),
                    CP.compact_by_mask_plain(arrays, mask, fill=fill))
        if name == "compact_record":
            arrays, mask, cap, fill = a
            got = CP.compact_record(arrays, mask, cap=cap, fill=fill)
            want = CP.compact_record_plain(arrays, mask, cap=cap, fill=fill)
            return ([*got[0], got[1], got[2]], [*want[0], want[1], want[2]])
        if name == "expand_route":
            return ([CP.expand_route(*a)], [CP.expand_route_plain(*a)])
        if name == "vocab_probe8":
            *q, rows, mask = a
            return ([J.vocab_probe8(*q, rows, mask)],
                    [J.vocab_probe8_plain(*q, rows, mask)])
        by, ln, br, rows, mask, lut = a
        return (M.merge_rows(by, ln, br, rows, mask, lut),
                M.merge_rows_local(by, ln, br, rows, mask=mask,
                                   pair_lut=lut))

    errs: dict = {}
    for key, args in seen.items():
        name = key[0]
        err = max_abs_err(*pair(name, args))
        shape = tuple(args[0][0].shape if isinstance(args[0], list)
                      else args[0].shape)
        print(f"mesh {label}: {name} {shape} max_abs_err {err} (recorded "
              "inputs)")
        if err:
            raise AssertionError(f"mesh {label}: {name} differs from its "
                                 f"plain version at {shape}")
        errs[name] = max(errs.get(name, 0), err)
    return errs


def _mesh_rank(rank: int, dev: str, store: str, vocab: str, rows: str,
               text: str, out: str) -> None:
    """One of two ranks sharing the card ``dev`` over gloo (spawned): the
    1-D and (1, 2) steps on its half of the rows and the sharded text;
    writes its results to ``out``/rank.pkl."""
    import pickle
    from datetime import timedelta

    import torch.distributed as dist

    from tokendagger_tpu_torch import (
        LLAMA4_PATTERN, DeviceEngine, load_tiktoken_model,
    )
    from tokendagger_tpu_torch.convert import merge_tables_from_ranks
    from tokendagger_tpu_torch.parallel import mesh as PM
    from tokendagger_tpu_torch.parallel.sharded_text import ShardedTextEncoder

    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=120))
    try:
        mesh = PM.get_mesh(2, device=dev, backend="gloo")
        m2 = PM.get_mesh_2d(1, 2, device=dev, backend="gloo")
        ranks = load_tiktoken_model(vocab)
        z = np.load(rows)
        mt = merge_tables_from_ranks(ranks, device=dev)
        bb, ln = PM.shard_rows(mesh, z["buf"], z["lens"])
        args = (bb, ln, mt.byte_rank, mt.pair_rows, mt.pair_mask)
        res = {"step": [x.cpu().numpy() for x in
                        PM.sharded_encode_step(mesh)(*args)],
               "step_2d": [x.cpu().numpy() for x in
                           PM.sharded_encode_step_2d(m2)(*args)]}
        eng = DeviceEngine(LLAMA4_PATTERN, ranks, {}, device=dev)
        st = ShardedTextEncoder(eng, mesh)
        with open(text, "rb") as f:
            data = f.read()
        st.encode(data[: 1 << 20])              # warm-up
        dist.barrier(group=mesh.group)
        p0, f0 = st.passes, st.fallbacks
        t = time.perf_counter()
        ids = st.encode(data)
        res.update(wall=time.perf_counter() - t, ids=ids,
                   passes=st.passes - p0, fallbacks=st.fallbacks - f0)
        with open(f"{out}/{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_mesh_pair(dev: str, ranks: dict, buf, lens, want_rows, data: bytes,
                  want_ids: list, one_rank_wall: float) -> None:
    """Two ranks sharing the card over gloo with CUDA tensors (spawned;
    the kernels are already built): steps over MESH_PAIR_ROWS rows and
    the sharded text of ``data``; ids and counters must equal one
    rank's."""
    import base64
    import multiprocessing as mp
    import pickle
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        with open(f"{d}/vocab.tiktoken", "wb") as f:
            for tb, r in ranks.items():
                f.write(base64.b64encode(tb) + b" %d\n" % r)
        np.savez(f"{d}/rows.npz", buf=buf, lens=lens)
        with open(f"{d}/text.bin", "wb") as f:
            f.write(data)
        ctx = mp.get_context("spawn")
        t = time.perf_counter()
        procs = [ctx.Process(target=_mesh_rank, args=(
            r, dev, f"{d}/store", f"{d}/vocab.tiktoken", f"{d}/rows.npz",
            f"{d}/text.bin", d)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"mesh pair: ranks exited {codes}")
        res = []
        for r in range(2):
            with open(f"{d}/{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
    half = len(lens) // 2
    n_tokens = sum(len(w) for w in want_rows)
    for r, x in enumerate(res):
        sub = want_rows[r * half : (r + 1) * half]
        exp = np.fromiter((i for w in sub for i in w), np.int64)
        ok = True
        for label in ("step", "step_2d"):
            tok, counts, tb, tt = x[label]
            ok = (ok and np.array_equal(tok[tok >= 0], exp)
                  and np.array_equal(counts, [len(w) for w in sub])
                  and int(tb) == int(lens.sum()) and int(tt) == n_tokens)
        same = x["ids"].tolist() == want_ids
        print(f"mesh pair rank {r}: rows {r * half}-{(r + 1) * half} equal "
              f"byte_pair_encode and both counters the totals {ok}; "
              f"sharded text ids equal one rank's {same}, passes "
              f"{x['passes']}, fallbacks {x['fallbacks']}")
        if not (ok and same and x["fallbacks"] == 0):
            raise AssertionError(f"mesh pair rank {r} differs from one rank")
    wall = max(x["wall"] for x in res)
    mb = len(data) / 1e6
    print(f"mesh pair: sharded text {len(data)} B at 2 ranks "
          f"{mb / wall:.2f} MB/s (wall {wall:.3f} s), at 1 rank "
          f"{mb / one_rank_wall:.2f} MB/s (wall {one_rank_wall:.3f} s); "
          f"phase {time.perf_counter() - t:.1f} s with the spawn")


def run_mesh(seed: int, mb: int, dev) -> tuple[dict, dict, dict]:
    """The mesh phase, parallel/ at one NCCL rank on the card (the module
    doc, step 11): the 1-D and 2-D steps, ShardedTextEncoder and
    mesh_resident_pipeline, then two gloo ranks sharing the card. Returns
    the one-rank legs' launches (counts set to 0 before each leg), each
    kernel's largest error against its plain version on the legs'
    recorded inputs, and the merge's timings at the mesh shapes."""
    import torch.distributed as dist

    from tokendagger_tpu_torch import (
        LLAMA4_PATTERN, DeviceEngine, HostEngine, Tokenizer,
    )
    from tokendagger_tpu_torch.convert import (
        merge_tables_from_ranks, tables_from_ranks,
    )
    from tokendagger_tpu_torch.ops.fused import caps_for
    from tokendagger_tpu_torch.parallel import mesh as PM
    from tokendagger_tpu_torch.parallel.resident_mesh import (
        mesh_resident_pipeline,
    )
    from tokendagger_tpu_torch.parallel.sharded_text import ShardedTextEncoder
    from tokendagger_tpu_torch.resident import (
        _check_window, _hot_codepoints, _hot_pieces, batch_pipeline,
    )
    from tokendagger_tpu_torch.splice import Splicer
    from tokendagger_tpu_torch.utils.windows import char_align, tile_windows

    t_phase = time.perf_counter()
    counters = mesh_counters()
    launches = dict.fromkeys(counters, 0)
    errs: dict = {}
    times: dict = {}

    def leg(fn):
        out, wall, run = count_runs(counters, fn)
        for k, v in run.items():
            launches[k] += v
        return out, wall, run

    def held(seen, label):
        for k, v in hold_recorded(seen, label).items():
            errs[k] = max(errs.get(k, 0), v)

    def synced(fn):
        def run():
            out = fn()
            torch.cuda.synchronize()
            return out
        return run

    ranks = reachable_vocab(seed)
    mesh = PM.get_mesh(1)
    print(f"mesh: get_mesh(1) rank {mesh.rank} of {mesh.size} on "
          f"{mesh.device}, backend {dist.get_backend(mesh.group)}")

    # ---- the steps on 262,144 pretoken rows of the engine text ----
    t = time.perf_counter()
    buf, lens, want_rows = mesh_rows(engine_texts(seed, mb)[0], ranks,
                                     MESH_ROWS, MESH_ROW_W)
    mt = merge_tables_from_ranks(ranks, device=dev)
    print(f"mesh steps: rows {buf.shape}, {int(lens.sum())} B, set-up "
          f"{time.perf_counter() - t:.1f} s")
    bb, ln = PM.shard_rows(mesh, buf, lens)
    args = (bb, ln, mt.byte_rank, mt.pair_rows, mt.pair_mask)
    steps = (("1-D step", PM.sharded_encode_step(mesh)),
             ("2-D step (1, 1)",
              PM.sharded_encode_step_2d(PM.get_mesh_2d(1, 1))))
    with recorded_inputs() as seen:
        for label, step in steps:
            out, wall, run = leg(synced(lambda: step(*args)))
            check_step(label, out, lens, want_rows)
            print(f"mesh {label}: wall {wall * 1e3:.3f} ms, launches "
                  f"{json.dumps({k: v for k, v in run.items() if v})}")
    held(seen, "steps")
    merge_args = next(a for k, a in seen.items() if k[0] == "merge")
    key = f"mesh steps {tuple(bb.shape)}"
    times[key] = merge_timings(merge_args, key)

    # ---- ShardedTextEncoder over 16 MB at the JAX defaults ----
    text = multiscript(MESH_TEXT_MB << 20, seed + 31)
    data = text.encode()
    host = Tokenizer("mesh", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                     special_tokens={}, backend="host", device=dev)
    t = time.perf_counter()
    want_ids = host.encode_ordinary(text)
    host_s = time.perf_counter() - t
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, {}, device=dev)
    t = time.perf_counter()
    reachable = eng.all_reachable()
    print(f"mesh: the merge-reachability audit of {len(ranks)} ranks "
          f"(DeviceEngine.all_reachable): {reachable} in "
          f"{time.perf_counter() - t:.2f} s")
    st = ShardedTextEncoder(eng, mesh)
    with recorded_inputs() as seen:
        st.encode(data[: 1 << 20])                   # warm-up: 8 passes
    held(seen, "sharded text")
    merge_args = next(a for k, a in seen.items() if k[0] == "merge")
    key = f"mesh text {tuple(merge_args[0].shape)}"
    times[key] = merge_timings(merge_args, key)
    p0, f0 = st.passes, st.fallbacks
    ids, wall, run = leg(lambda: st.encode(data))
    passes, fallbacks = st.passes - p0, st.fallbacks - f0
    same = ids.tolist() == want_ids
    print(f"mesh sharded text: {len(data)} B, shards {st.W} B + halo {st.H} "
          f"B, ids equal the host engine's {same}; passes {passes}, "
          f"fallbacks {fallbacks}; {len(data) / 1e6 / wall:.2f} MB/s wall "
          f"({wall:.3f} s; native host engine {host_s:.3f} s); launches "
          f"{json.dumps({k: v for k, v in run.items() if v})}")
    if not same or fallbacks:
        raise AssertionError("mesh sharded text: ids differ from the host "
                             "engine's, or a pass fell back")
    idle_share(lambda: st.encode(data), "mesh sharded text")

    # ---- mesh_resident_pipeline at 8 x 1 MB with the 200,000 stand-in ----
    r200 = standin_vocab(200_000, seed, extra=multiscript(1 << 20, seed + 4))
    tables = tables_from_ranks(r200, device=dev)
    host200 = Tokenizer("standin", pat_str=LLAMA4_PATTERN,
                        mergeable_ranks=r200, special_tokens={},
                        backend="host", device=dev)
    splicer200 = Splicer(r200)
    p_cap = caps_for(WINDOW)["p_cap"]
    for impl, corp in (("ascii", corpus(9 * WINDOW, seed + 41)),
                       ("general", multiscript(9 * WINDOW, seed + 9))):
        wins, nbs = tile_windows(corp.encode(), WINDOW, BATCH)
        win_bytes = [wins[b, : nbs[b]].tobytes() for b in range(BATCH)]
        kw: dict = dict(impl=impl)
        cap = p_cap
        if impl == "general":
            hot_cps, u_cap, c_cap = _hot_codepoints(win_bytes, WINDOW, WINDOW)
            probe_cfg, cap = _hot_pieces(
                HostEngine(LLAMA4_PATTERN, r200, {}), win_bytes, r200, p_cap)
            if hot_cps is None or probe_cfg is None:
                raise AssertionError("mesh pipeline: a hot route's gate is "
                                     "shut on the multi-script windows")
            kw.update(c_cap=c_cap, probe_hot_cfg=probe_cfg,
                      class_hot_cfg=dict(hot_cps=hot_cps, u_cap=u_cap))
        fn = mesh_resident_pipeline(mesh, tables, None, None, window=WINDOW,
                                    p_cap=cap, **kw)
        d, nb = PM.shard_rows(mesh, wins, nbs)
        with recorded_inputs() as seen:
            synced(lambda: fn(d, nb))()
        held(seen, f"pipeline {impl}")
        out, wall, run = leg(synced(lambda: fn(d, nb)))
        hot = kw.get("class_hot_cfg", {})
        want = batch_pipeline(
            d, nb, impl=impl, p_cap=cap, rows=tables.vhash8_rows,
            vmask=tables.vhash8_mask, c_cap=kw.get("c_cap"),
            hot_cps=hot.get("hot_cps"), u_cap=hot.get("u_cap"),
            probe_hot_cfg=kw.get("probe_hot_cfg"))
        equal = all(torch.equal(a, b) for a, b in zip(out[:9], want))
        out_np = [o.cpu().numpy() for o in out]
        match = all(_check_window(tuple(o[b] for o in out_np[:9]),
                                  win_bytes[b], host200, splicer200)
                    for b in range(BATCH))
        counted = (int(out[9]) == int(out[1].sum())
                   and int(out[10]) == int(nbs.sum()))
        ms = traced(lambda: fn(d, nb))[0]
        print(f"mesh pipeline {impl}: {BATCH} x {WINDOW} B, p_cap {cap}"
              f"{', hot codepoints and pieces' if hot else ''}: outputs "
              f"equal run_resident's batch_pipeline {equal}, ids equal the "
              f"host engine's {match}, counters the totals {counted}; "
              f"device {ms} ms a batch (trace), kernel "
              f"{BATCH * WINDOW / 1e6 / (ms / 1e3) if ms else 0:.2f} MB/s; "
              f"wall {wall * 1e3:.3f} ms; launches "
              f"{json.dumps({k: v for k, v in run.items() if v})}")
        if not (equal and match and counted and ms):
            raise AssertionError(f"mesh pipeline {impl}: outputs, ids or "
                                 "counters differ, or the trace held no "
                                 "kernel")

    # ---- two ranks sharing the card over gloo ----
    pair_data = char_align(np.frombuffer(data[: MESH_PAIR_MB << 20],
                                         np.uint8)).tobytes()
    t = time.perf_counter()
    want_pair = st.encode(pair_data)
    one_wall = time.perf_counter() - t
    run_mesh_pair(str(mesh.device), ranks, buf[:MESH_PAIR_ROWS],
                  lens[:MESH_PAIR_ROWS],
                  want_rows[:MESH_PAIR_ROWS], pair_data, want_pair.tolist(),
                  one_wall)
    dead = [k for k, v in launches.items() if not v]
    if dead:
        raise AssertionError(f"mesh: kernels never launched: {dead}")
    dist.destroy_process_group()
    print(f"mesh: launches {json.dumps(launches)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, errs, {"merge": times}

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
    rows.append(check_probe_kernel(args.seed, "cuda"))
    k1_group_err, k1_group_times = check_k1_groups(args.seed, "cuda")
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], k1_group_err)
    # each path runs with the counts set to 0 just before it; a kernel on
    # several paths reports the sum of its launches as "launches", and
    # each path's count in "launches_by_path"
    # the resident path first: its kernels' library yardsticks are traced
    # before the long stream and engine phases
    resident, inputs = run_resident_phase(args.seed, "cuda")
    rows += check_resident_kernels(inputs["auto cap"], "cuda")
    single, single_inputs = run_single_phase(args.seed, "cuda")
    formulations, form_inputs = run_formulations(args.seed, "cuda")
    resident_errs, resident_times = check_resident_shared(
        {**inputs, **single_inputs, **form_inputs}, args.seed, "cuda")
    del inputs, single_inputs, form_inputs
    char_form_err, _ = check_char_forms(args.seed, "cuda")
    resident_errs["piece_starts_cp"] = max(
        resident_errs.get("piece_starts_cp", 0), char_form_err)
    time_sort_formulations(args.seed, "cuda")
    stream = run_stream(args.seed, args.mb, "cuda")
    engine, engine_errs, engine_times = run_engine(args.seed,
                                                   args.engine_mb, "cuda")
    row_entry, grid_errs, grid_times = check_grid_kernels(args.seed, "cuda")
    rows.append(row_entry)
    merge_row, pieces, merge_windows = run_pieces(args.seed, "cuda")
    rows.append(merge_row)
    paths = dict(stream=stream, engine=engine, resident=resident,
                 single=single, formulations=formulations,
                 batch=run_batch(args.seed, "cuda"),
                 corpus=run_corpus(args.seed, "cuda"),
                 streaming=run_streaming(args.seed, "cuda"),
                 kimi=run_kimi(args.seed, "cuda"),
                 pieces=pieces, merge_windows=merge_windows,
                 host=run_host(args.seed, args.engine_mb),
                 auto=run_auto(args.seed, args.engine_mb, "cuda"))
    paths["mesh"], mesh_errs, mesh_times = run_mesh(args.seed,
                                                    args.engine_mb, "cuda")
    for r in rows:
        name = r["name"]
        by_path = {p: v.get(name, 0) for p, v in paths.items()}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        r["max_abs_err"] = max(r["max_abs_err"], engine_errs.get(name, 0),
                               resident_errs.get(name, 0),
                               grid_errs.get(name, 0),
                               mesh_errs.get(name, 0))
        more = {**resident_times.get(name, {}),
                **engine_times.get(name, {}),
                **grid_times.get(name, {}),
                **mesh_times.get(name, {}),
                **(k1_group_times if name == "piece_starts" else {})}
        for k, v in by_shape(more).items():
            r.setdefault(k, {}).update(v)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_call_ms",
            "library", "library_traces", "launches_per_call", "passes",
            "blocks_per_window", "ms_by_shape", "call_ms_by_shape",
            "plain_ms_by_shape", "bound_ms_by_shape", "library_ms_by_shape",
            "launches_per_call_by_shape", "blocks_per_window_by_shape",
            "merges_by_shape", "longest_row_merges_by_shape",
            "latency_floor_ms", "l2_read_ns", "latency_floor_ms_by_shape",
            "lanes_per_row_by_shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))

    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
