"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--mb 16]

1. Builds the CUDA kernels of tokendagger_tpu_torch (one nvcc per source,
   in parallel) and prints the card, its power limit and the build time.
2. Holds each kernel of the window pipeline against its plain torch
   version on the card, at the main path's shapes (8 windows of 1 MB,
   p_cap 349,568), on seeded ASCII windows plus edge cases (an empty
   window, a one-piece window, punctuation that overflows p_cap, a length
   that is not a multiple of 32, garbage bytes beyond the length). Every
   output must be equal; each kernel's median time (CUDA events) is
   printed beside its bound and the plain version's time.
3. Drives ResidentStream on the card over at least 16 MB with a seeded
   200,000-rank stand-in vocabulary, checks the first batch's ids against
   the host engine, no host fallback, and one launch of each kernel per
   batch, and prints the wall rate and per-stage times.
4. Prints a "kernels" JSON line, then the card's name and power limit, and
   last {"ok": true, "device": {...}}. Any failure exits non-zero first.
"""

from __future__ import annotations

import argparse
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


def standin_vocab(n_ranks: int, seed: int) -> dict[bytes, int]:
    """256 bytes, every pretoken of a seeded corpus sample with all its
    prefixes, then seeded random ASCII strings of 2-16 bytes."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine

    ranks = {bytes([i]): i for i in range(256)}
    sample = corpus(1 << 20, seed + 1)
    host = HostEngine(LLAMA4_PATTERN, ranks, {})
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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


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
    for prof in ("llama4", "nocontract", "cl100k", "gpt2"):
        got = BP.piece_starts_bits(by, nb, profile=prof)
        want = BP.piece_starts_bits_plain(by, nb, profile=prof)
        err = max_abs_err([got], [want])
        print(f"K1 piece_starts[{prof}]: max_abs_err {err}")
        if err:
            bad = (got != want).nonzero()[:5].tolist()
            raise AssertionError(f"K1 {prof} differs at {bad}")
    starts = BP.piece_starts_bits(by, nb, profile="llama4")
    ms = median_ms(lambda: BP.piece_starts_bits(by, nb, profile="llama4"))
    plain = median_ms(
        lambda: BP.piece_starts_bits_plain(by, nb, profile="llama4"), reps=3)
    passes = BP.starts_passes("llama4", N)
    bms, bby = bound(B * N + B * N / 8 + 4 * B, passes * B * N / 32)
    print(f"K1 piece_starts: {ms:.4f} ms (plain {plain:.3f} ms, bound "
          f"{bms:.5f} ms by {bby}; {passes} passes over the planes)")
    rows.append(dict(
        name="piece_starts", route="cuda",
        source="tokendagger_tpu_torch/csrc/piece_starts.cu",
        replaces="tokendagger_tpu/ops/bitplane.py:1152",
        max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=bby,
        library_ms=None))

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
    ms = median_ms(lambda: CP.compact_piece_keys(starts, by, nb, p_cap,
                                                 packed=True))
    plain = median_ms(lambda: CP.compact_piece_keys_plain(
        starts, by, nb, p_cap, packed=True), reps=5)
    idx = torch.arange(N, device=dev).expand(B, N)
    lib = median_ms(lambda: torch.masked_select(idx, flags))
    key_bytes = int(torch.clamp(got[1], max=16).sum())
    bms, bby = bound(B * N / 8 + key_bytes + 4 * B + 24 * B * p_cap + 4 * B,
                     B * N)
    print(f"K2+K3 compact_piece_keys: {ms:.4f} ms (plain {plain:.3f} ms, "
          f"masked_select {lib:.4f} ms, bound {bms:.5f} ms by {bby})")
    rows.append(dict(
        name="compact_piece_keys", route="cuda",
        source="tokendagger_tpu_torch/csrc/compact.cu",
        replaces="tokendagger_tpu/ops/compact_pallas.py:288 (compact_tiles) "
                 "+ :561 (degap_keys)",
        max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=bby,
        library_ms=lib))

    # ---- K4: miss-span compaction at finalize's shapes ----
    sb, pl = got[0], got[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    live = torch.arange(p_cap, device=dev) < torch.clamp(got[6], max=p_cap)[:, None]
    miss = live & (torch.rand((B, p_cap), generator=g, device=dev) < 0.05)
    miss[0] = live[0]          # every live slot missed
    k_got = CP.compact_by_mask([sb, pl], miss)
    k_want = CP.compact_by_mask_plain([sb, pl], miss)
    err = max_abs_err(k_got, k_want)
    print(f"K4 compact_by_mask: max_abs_err {err}")
    if err:
        raise AssertionError("K4 differs from its plain version")
    ms = median_ms(lambda: CP.compact_by_mask([sb, pl], miss))
    plain = median_ms(lambda: CP.compact_by_mask_plain([sb, pl], miss))
    both = torch.stack([sb, pl])
    lib = median_ms(lambda: torch.masked_select(both, miss))
    kept = int(miss.sum())
    bms, bby = bound(B * p_cap + 8 * kept + 8 * B * p_cap, B * p_cap)
    print(f"K4 compact_by_mask: {ms:.4f} ms (plain {plain:.3f} ms, "
          f"masked_select {lib:.4f} ms, bound {bms:.5f} ms by {bby})")
    rows.append(dict(
        name="compact_by_mask", route="cuda",
        source="tokendagger_tpu_torch/csrc/compact.cu",
        replaces="tokendagger_tpu/ops/compact_pallas.py:830",
        max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=bby,
        library_ms=lib))
    return rows


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=16)
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
    rows = check_kernels(args.seed, "cuda")
    launches = run_stream(args.seed, args.mb, "cuda")
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
