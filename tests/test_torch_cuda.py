"""The port's CUDA kernels against their plain torch versions on the card,
at small shapes. Needs a card: every test here is marked ``cuda`` and
skips without one. On the card (no JAX there) run

    TD_REAL_BACKEND=1 python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from tokendagger_tpu_torch.ops import bitplane as BP
from tokendagger_tpu_torch.ops import compact as CP
from tokendagger_tpu_torch.ops import pretokenize as PT
from torch_port_util import (
    ascii_text, invalid_utf8, multiscript_text, prose_text, stage,
)

pytestmark = pytest.mark.cuda
PROFILES = ["llama4", "nocontract", "cl100k", "gpt2"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _windows(seed, n, dev):
    rng = np.random.default_rng(seed)
    texts = [ascii_text(rng, n), prose_text(rng, n - 77), "", "a" * n,
             "! " * (n // 2), "x"]
    by, nb = stage(texts, n, rng)
    return torch.from_numpy(by).to(dev), torch.from_numpy(nb).to(dev)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n", [1024, 1 << 15])
def test_k1_equals_plain(dev, profile, n):
    by, nb = _windows(n, n, dev)
    got = BP.piece_starts_bits(by, nb, profile=profile)
    want = BP.piece_starts_bits_plain(by, nb, profile=profile)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("profile", PROFILES)
def test_k1_segmented_entries_equal_plain(dev, profile, B):
    """All three K1 entries spread each window over many blocks; B = 1 and
    8 windows of 64 K chars, with an empty window, lengths that are not a
    multiple of 32 and one that ends inside the first segment."""
    n = 1 << 16
    spw = BP.starts_blocks_per_window("bytes", B, n)
    assert spw > 1 and spw * B >= min(132, 16 * B)
    first = 32 * (n // 32 // spw) - 5            # inside segment 0
    lengths = [n - 77, 0, first, 12345, n, 1000, 33, n // 2]
    rng = np.random.default_rng(B)
    by, nb = stage([ascii_text(rng, k) for k in lengths], n, rng)
    cp = rng.integers(0, 0x110000, by.shape).astype(np.int32)
    for b, k in enumerate(lengths):
        cp[b, :k] = [ord(c) for c in multiscript_text(rng, k)[:k]]
    m = np.array(lengths, np.int32)
    words = BP.char_class_words(profile)[cp].astype(np.int32)
    entries = [
        (BP.piece_starts_bits, BP.piece_starts_bits_plain, by, nb),
        (lambda x, y, profile: BP.piece_starts_chars(
            x, y, profile=profile, packed_out=True),
         BP.piece_starts_chars_plain, cp, m),
        (BP.piece_starts_words, BP.piece_starts_words_plain, words, m)]
    for fn, plain, x, y in entries:
        for r in range(0, len(lengths), B):      # one launch per B windows
            xs = torch.from_numpy(x[r:r + B]).to(dev)
            ys = torch.from_numpy(y[r:r + B]).to(dev)
            got = fn(xs, ys, profile=profile)
            torch.cuda.synchronize()
            assert torch.equal(got, plain(xs, ys, profile=profile)), (fn, r)


@pytest.mark.parametrize("profile", PROFILES)
def test_k1_past_resident_blocks_equals_plain(dev, profile):
    """300 windows of 1024 chars, more than the card holds K1 blocks (264
    on the H100): every entry runs them in groups of one block per window
    and equals its plain version."""
    B, n = 300, 1024
    rng = np.random.default_rng(B)
    lengths = rng.integers(0, n + 1, B)
    lengths[:3] = (0, n, 33)
    by, nb = stage([ascii_text(rng, int(k)) for k in lengths], n, rng)
    cp = rng.integers(0, 0x110000, by.shape).astype(np.int32)
    for b, k in enumerate(lengths):
        cp[b, :k] = [ord(c) for c in multiscript_text(rng, int(k))[:k]]
    m = lengths.astype(np.int32)
    words = BP.char_class_words(profile)[cp].astype(np.int32)
    assert BP.starts_blocks_per_window("bytes", B, n) >= 1
    entries = [
        (BP.piece_starts_bits, BP.piece_starts_bits_plain, by, nb),
        (lambda x, y, profile: BP.piece_starts_chars(
            x, y, profile=profile, packed_out=True),
         BP.piece_starts_chars_plain, cp, m),
        (BP.piece_starts_words, BP.piece_starts_words_plain, words, m)]
    for fn, plain, x, y in entries:
        xs, ys = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        got = fn(xs, ys, profile=profile)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(xs, ys, profile=profile)), fn


def _k2k3_rows(B, N, seed, dev):
    """B windows of N bytes cycling five kinds: prose with a whitespace run
    of at least 64 KB (or N/4 below 256 KB) crossing tiles and a ragged
    length; full prose; an empty window; one piece (N letters);
    punctuation that overflows. Returns the byte windows, their lengths
    and their start flags as bytes (K1's, so N need not be a multiple of
    1024: they come from the windows padded to one)."""
    rng = np.random.default_rng(seed)
    prose = prose_text(rng, 1 << 16)
    fill = (prose * (N // len(prose) + 1))[:N]
    run = max(1 << 16, N // 8) if N >= 1 << 18 else N // 4
    kinds = [(fill[: N // 3] + " " * run + fill)[:N], fill, "", "a" * N,
             "! " * (N // 2)]
    texts = [kinds[b % len(kinds)] for b in range(B)]
    by, nb = stage(texts, N, rng)
    nb[0] = min(nb[0], N - 77)              # not a multiple of 32
    nb[4::5] -= 5
    Np = -(-N // 1024) * 1024
    pad = np.zeros((B, Np), np.uint8)
    pad[:, :N] = by
    by, nb = torch.from_numpy(by).to(dev), torch.from_numpy(nb).to(dev)
    words = BP.piece_starts_bits(torch.from_numpy(pad).to(dev), nb)
    return by, nb, BP.unpack_mask(words)[:, :N].contiguous()


# (flags, B, N): packed words need N % 1024 == 0, byte flags N % 32 == 0
K2K3_CASES = [(f, B, N) for B, N in [(1, 1024), (3, 1024), (300, 1024),
                                     (1, 1 << 20), (3, 1 << 20), (1, 1 << 22),
                                     (3, 32 * 1023), (300, 32 * 33)]
              for f in ("bool", "uint8", "packed")
              if f != "packed" or N % 1024 == 0]


@pytest.mark.parametrize("flags,B,N", K2K3_CASES)
def test_k2k3_equals_plain(dev, flags, B, N):
    """All seven outputs equal the plain version, with p_cap one below,
    at and one above the first window's piece count (the other windows
    below and above it: empty, one piece, overflowing punctuation)."""
    by, nb, st = _k2k3_rows(B, N, B + N, dev)
    if flags == "uint8":
        st = st.to(torch.uint8) * 3
    elif flags == "packed":
        st = BP.pack_mask(st)
    n0 = int(CP.compact_piece_keys_plain(st, by, nb, N + 1,
                                         packed=flags == "packed")[6][0])
    assert n0 > 1
    for p_cap in (n0 - 1, n0, n0 + 1):
        got = CP.compact_piece_keys(st, by, nb, p_cap,
                                    packed=flags == "packed")
        want = CP.compact_piece_keys_plain(st, by, nb, p_cap,
                                           packed=flags == "packed")
        torch.cuda.synchronize()
        for name, g, w in zip(("start_b", "piece_len", "k0", "k1", "k2",
                               "k3", "n_pieces"), got, want):
            assert torch.equal(g, w), (name, p_cap)


def test_k2k3_streams_and_epochs(dev):
    """Back-to-back calls on one stream reuse its status words under a new
    epoch; calls on a second stream, queued while the first still runs,
    get their own words. Every result equals the plain version."""
    by, nb, st = _k2k3_rows(3, 1 << 20, 7, dev)
    words = BP.pack_mask(st)
    p_cap = (1 << 20) // 3
    want = {p: CP.compact_piece_keys_plain(words if p else st, by, nb, p_cap,
                                           packed=p) for p in (False, True)}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(2):
        for p in (False, True):
            got.append((p, CP.compact_piece_keys(words if p else st, by, nb,
                                                 p_cap, packed=p)))
            with torch.cuda.stream(side):
                got.append((p, CP.compact_piece_keys(
                    words if p else st, by, nb, p_cap, packed=p)))
    torch.cuda.synchronize()
    for p, g in got:
        for a, b in zip(g, want[p]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("P", [100, 8192, 20001, 300001])
def test_k4_equals_plain(dev, k, P):
    """Rows: random 30%, empty, all kept, random 2%; P not a multiple of
    32 (rows not 16-byte aligned) and P over many tiles (look-back past
    32 tiles)."""
    g = torch.Generator(device=dev).manual_seed(P + k)
    arrays = [torch.randint(-2**31, 2**31 - 1, (4, P), generator=g,
                            device=dev, dtype=torch.int32) for _ in range(k)]
    mask = torch.rand((4, P), generator=g, device=dev) < 0.3
    mask[1] = False
    mask[2] = True
    mask[3] = torch.rand((P,), generator=g, device=dev) < 0.02
    for fill in (0, -1):
        for _ in range(2):             # a second launch on the same statuses
            got = CP.compact_by_mask(arrays, mask, fill=fill)
            want = CP.compact_by_mask_plain(arrays, mask, fill=fill)
            torch.cuda.synchronize()
            assert len(got) == k
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_stream_card_equals_cpu(dev):
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, ResidentStream

    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(9)
    corpus = (prose_text(rng, 5 * 32768) + " é " + "! " * 20000).encode()
    outs = []
    for d in ("cuda", "cpu"):
        rs = ResidentStream(ranks, specials, LLAMA4_PATTERN, window=1 << 15,
                            batch=2, device=d)
        outs.append(rs.encode(corpus))
    (a, sa), (b, sb) = outs
    assert a == b
    assert sa.host_fallback_windows == sb.host_fallback_windows >= 1
    assert sa.spliced_pieces == sb.spliced_pieces


def _utf8_windows(seed, n, dev):
    rng = np.random.default_rng(seed)
    raws = [multiscript_text(rng, n).encode()[:n], invalid_utf8(rng, n),
            b"", "\U0001f642".encode() * (n // 4), b"\xff" * n,
            prose_text(rng, n).encode()]
    by = rng.integers(0, 256, (len(raws), n)).astype(np.uint8)
    nb = np.zeros(len(raws), np.int32)
    for b, raw in enumerate(raws):
        by[b, : len(raw)] = np.frombuffer(raw, np.uint8)
        nb[b] = len(raw)
    return torch.from_numpy(by).to(dev), torch.from_numpy(nb).to(dev)


@pytest.mark.parametrize("n", [1000, 8192, 1 << 16])
def test_k9_equals_plain(dev, n):
    by, nb = _utf8_windows(n, n, dev)
    got = PT.utf8_decode_block(by)
    want = PT.utf8_decode_block_plain(by)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the decode around it: card == CPU
    on_card = PT.utf8_decode(by, nb)
    on_cpu = PT.utf8_decode(by.cpu(), nb.cpu())
    for g, w in zip(on_card, on_cpu):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n", [1024, 1 << 15])
def test_k1_codepoints_equals_plain(dev, profile, n):
    by, nb = _utf8_windows(n + 1, n, dev)
    cp, _, _, m = PT.utf8_decode(by, nb)
    cp[1, 5] = 0x7FFFFFFF            # out-of-range codepoints have no class
    cp[1, 9] = -3
    got = BP.piece_starts_chars(cp, m, profile=profile, packed_out=True)
    want = BP.piece_starts_chars_plain(cp, m, profile=profile)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_engine_card_equals_cpu(dev):
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine, Tokenizer

    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(11)
    text = multiscript_text(rng, 40000) + " " * 70000 + "a " * 30000
    engines = [DeviceEngine(LLAMA4_PATTERN, ranks, specials, device=d)
               for d in ("cuda", "cpu")]
    engines[0]._window = 1 << 16       # start as small as the CPU's
    a, b = (e.encode_stream(text.encode()) for e in engines)
    assert a.tolist() == b.tolist()
    # the space run grows the card's window; the CPU's cannot grow and
    # takes the host route
    assert engines[0].stats.grown_windows >= 1
    assert engines[1].stats.host_advance_windows >= 1
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, device="cuda")
    sample = text[:20000] + "<|bos|>" + text[:3000]
    ids = tok.encode(sample, allowed_special="all")
    assert ids == engines[1].host.encode(sample, tok.special_tokens_set)[0]
    assert tok.decode(ids) == sample


def test_window_spans_share_the_device_clock(dev, tmp_path):
    """A traced encode of a 1 MB multi-script text: every stage of a
    window launched device work (``stage_device_us`` over the
    ``td.window.*`` ranges); each window's last kernel or copy ends by the
    end of its ``td.window.read`` range, plus 50 µs (the ranges lie on the
    clock of the device events); the ``td.window`` ranges sum to the
    ``device_s`` delta within 10%."""
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine, Tokenizer
    from tokendagger_tpu_torch.utils import profiling

    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(17)
    text = multiscript_text(rng, 640_000)
    assert len(text.encode()) > 1_000_000
    plain = HostEngine(LLAMA4_PATTERN, {bytes([i]): i for i in range(256)},
                       {})
    for a, b in plain.split_spans(text):       # every piece a whole token
        ranks.setdefault(text[a:b].encode(), len(ranks))
    specials = {k: v + len(ranks) for k, v in specials.items()}
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, device="cuda")
    want = tok.encode(text, allowed_special="all")   # builds, warms up
    eng = tok._get_device()
    with profiling.profile_trace(str(tmp_path)):
        tok.encode(text[:5000], allowed_special="all")  # the trace settles
        torch.cuda.synchronize()
        d0 = eng.stats.device_s
        got = [tok.encode(text, allowed_special="all") for _ in range(3)]
        d1 = eng.stats.device_s
    assert all(g == want for g in got)
    events = profiling.trace_events(str(tmp_path))
    stages = ["td.window.stage", "td.window.decode", "td.window.starts",
              "td.window.compact", "td.window.probe", "td.window.finalize",
              "td.window.read"]
    us = profiling.stage_device_us(events, stages)
    assert sorted(us) == sorted(stages)
    assert all(v > 0 for v in us.values()), us

    def ranges(name):
        return sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                      if e.get("ph") == "X" and e.get("name") == name
                      and e.get("cat") == "user_annotation")
    windows, reads = ranges("td.window"), ranges("td.window.read")
    assert len(windows) == len(reads) >= 4
    launch = {e["args"]["correlation"]: (e["ts"], e["tid"]) for e in events
              if e.get("ph") == "X"
              and e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    device = [(launch.get(e.get("args", {}).get("correlation")),
               e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    for (a, b, tid), (_, read_end, _) in zip(windows, reads):
        ends = [end for at, end in device
                if at is not None and at[1] == tid and a <= at[0] <= b]
        assert ends and max(ends) <= read_end + 50.0, (max(ends), read_end)
    calls = ranges("td.encode")[1:]                  # the three timed
    traced_s = sum(b - a for a, b, _ in windows
                   if any(c <= a <= d for c, d, _ in calls)) * 1e-6
    assert traced_s == pytest.approx(d1 - d0, rel=0.10)


# ---------------------------------------------------------------------------
# The general pipeline's kernels: K5+K6, K7+K8, K1's class-word entry
# ---------------------------------------------------------------------------


def _route_masks(dev, B, N, cap, seed):
    """Rows: random 30%, skewed (empty first half), empty, all kept (an
    overflow when cap < N), random 60%, random 5%, and all kept after the
    first 1000 (the kept count crosses cap inside a 4096-element tile)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand((B, N), generator=g, device=dev) < 0.3
    mask[1, : N // 2] = False
    mask[2] = False
    mask[3] = True
    mask[4] = torch.rand((N,), generator=g, device=dev) < 0.6
    mask[5] = torch.rand((N,), generator=g, device=dev) < 0.05
    mask[6] = torch.arange(N, device=dev) >= 1000
    return mask, g


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("N,cap", [(100, 64), (65536, 32768), (70001, 90000),
                                   (1 << 20, 655360)])
def test_k5k8_equals_plain(dev, k, N, cap):
    """K5+K6 on rows of one tile, of many (look-back past 32 tiles at
    2^20), with cap below and above N (the fill of [N, cap)); twice on the
    same status words, and once on a second stream with its own."""
    B = 7
    mask, g = _route_masks(dev, B, N, cap, N + k)
    arrays = [torch.randint(-2**31, 2**31 - 1, (B, N), generator=g,
                            device=dev, dtype=torch.int32) for _ in range(k)]
    side = torch.cuda.Stream(dev)
    for fill in (0, -1):
        want = CP.compact_record_plain(arrays, mask, cap=cap, fill=fill)
        runs = [CP.compact_record(arrays, mask, cap=cap, fill=fill)
                for _ in range(2)]
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            runs.append(CP.compact_record(arrays, mask, cap=cap, fill=fill))
        torch.cuda.synchronize()
        for got in runs:
            assert len(got[0]) == k
            for a, b in zip(got[0], want[0]):
                assert a.is_contiguous() and torch.equal(a, b)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[2], want[2])
    dense = got[0][0]
    back = CP.expand_route(dense, got[2], mask)
    assert torch.equal(back, CP.expand_route_plain(dense, got[2], mask))
    # a mask narrower than the compaction's
    sub = mask & (torch.rand((B, N), generator=g, device=dev) < 0.5)
    assert torch.equal(CP.expand_route(dense, got[2], sub),
                       CP.expand_route_plain(dense, got[2], sub))


@pytest.mark.parametrize("profile", PROFILES)
def test_k1_words_equals_plain(dev, profile):
    n = 1 << 15
    by, nb = _utf8_windows(n + 2, n, dev)
    cp, _, _, m = PT.utf8_decode(by, nb)
    cp = cp.contiguous()
    cls, _ = BP.class_lookup_hot(cp, m, hot_cps=(32, 101, 0x3000),
                                 u_cap=n, table=BP.char_class_words(profile))
    got = BP.piece_starts_words(cls, m, profile=profile)
    want = BP.piece_starts_words_plain(cls, m, profile=profile)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # and through the codepoint entry, the same flags
    assert torch.equal(got, BP.piece_starts_chars(cp, m, profile=profile,
                                                  packed_out=True))


def test_general_stages_card_equal_cpu(dev):
    from tokendagger_tpu_torch.ops import join as JN
    from tokendagger_tpu_torch.tables import build_vhash8
    from torch_port_util import collision_vocab

    n = 1 << 16
    by, nb = _utf8_windows(21, n, dev)
    res = []
    for d_, nb_ in ((by, nb), (by.cpu(), nb.cpu())):
        out = PT.utf8_decode_tiles(d_, nb_, c_cap=n // 2)
        flags = PT.expand_starts_replay(
            BP.piece_starts_chars(out[0], out[2]), out[1], out[3])
        cls = BP.class_lookup_hot(out[0], out[2], hot_cps=(32, 97, 101),
                                  u_cap=n // 4)
        res.append([t.cpu() for t in (*out, flags, *cls)])
    for a, b in zip(*res):
        assert torch.equal(a, b)
    ranks, crowd = collision_vocab(seed=3)
    rows, mask, _ = build_vhash8(ranks)
    toks = list(ranks)[:300] + crowd
    keys = [JN.piece_key_words(t) for t in toks]
    hot = keys[:40] + [JN.piece_key_words(b"\xff\xfe\xfd\xfc\x80!")]
    hr = tuple(ranks.get(t, -1) for t in toks[:40]) + (-1,)
    q = torch.tensor([k for k in keys for _ in range(3)], dtype=torch.int64)
    q = torch.where(q >= 2**31, q - 2**32, q).to(torch.int32)
    q = q.t().contiguous().reshape(5, 3, -1)
    res = []
    for d_ in (dev, torch.device("cpu")):
        args = [q[j].to(d_).contiguous() for j in range(5)]
        res.append(JN.vocab_probe_hot(
            *args, torch.as_tensor(rows, device=d_), mask, hot_keys=tuple(hot),
            hot_ranks=hr, u_cap=256))
    for a, b in zip(*res):
        assert torch.equal(a.cpu(), b)


def test_second_card_equals_cpu(dev):
    """Every kernel runs on its tensors' card: the public API's encode and
    decode and run_resident's general pipeline on cuda:1 while cuda:0 is
    the current card, against the CPU."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, Tokenizer, run_resident

    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(17)
    text = multiscript_text(rng, 40000) + "<|bos|>" + prose_text(rng, 30000)
    corpus = multiscript_text(rng, 2 * 32768).encode()
    kw = dict(pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
              special_tokens=specials)
    want = Tokenizer("t", device="cpu", **kw).encode(text,
                                                     allowed_special="all")
    with torch.cuda.device(0):
        tok = Tokenizer("t", device="cuda:1", **kw)
        assert tok.encode(text, allowed_special="all") == want
        assert tok.decode(want) == text
        for cap in (3.0, 0):
            r = run_resident(ranks, specials, LLAMA4_PATTERN, corpus,
                             window=32768, n_windows=2, batch=2, reps=1,
                             cap_bytes_per_piece=cap, probe_impl="chunks",
                             overlap_trial=False, device="cuda:1")
            assert r.match_host and r.overflow_windows == 0


def test_resident_card_equals_cpu(dev):
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, run_resident

    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(13)
    corpus = multiscript_text(rng, 3 * 32768).encode()
    counters = (CP.compact_record, CP.expand_route, BP.piece_starts_chars,
                BP.piece_starts_words)
    for cap in (3.0, 0):
        r = []
        for d in ("cuda", "cpu"):
            for k in counters:
                k.launches = 0
            r.append(run_resident(
                ranks, specials, LLAMA4_PATTERN, corpus, window=32768,
                n_windows=2, batch=2, reps=2, cap_bytes_per_piece=cap,
                probe_impl="chunks", overlap_trial=d == "cuda", device=d))
            if d == "cuda":
                n = [k.launches for k in counters]
        assert r[0].match_host and r[1].match_host
        for f in ("impl", "total_tokens", "cap_bpp", "probe_impl",
                  "probe_hot", "overflow_windows"):
            assert getattr(r[0], f) == getattr(r[1], f), f
        assert r[0].device_ms > 0 and r[0].overlap is not None
        assert set(r[0].stage_us) == {"decode", "starts", "expand",
                                      "compact", "probe", "finalize"}
        # per pipeline run: K5+K6 and K7+K8 once (the decode's route),
        # three times under the auto capacity (both hot routes); K1's
        # codepoint entry, or with the hot codepoints its class-word entry
        runs = n[2] + n[3]
        assert runs >= 4
        per = 3 if cap == 0 else 1
        assert n[0] == n[1] == per * runs
        assert (n[3] if cap == 0 else n[2]) == runs


# ---------------------------------------------------------------------------
# Batched grids of short segments: K1's row entry, K2+K3 and K4 at the
# grid shapes, and threads sharing one engine
# ---------------------------------------------------------------------------


def _grid(B, W, seed, dev):
    """A (B, W) grid of multi-script rows as the engine stages them: every
    fifth row empty, one exactly W bytes, one piece, all whitespace; rows
    0-padded."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(B):
        kind = b % 6
        if kind == 0:
            raw = b""
        elif kind == 1:
            raw = prose_text(rng, W).encode()[:W]
        elif kind == 2:
            raw = b"a" * int(rng.integers(1, W + 1))
        elif kind == 3:
            raw = b" \t\n " * (W // 4)
        else:
            raw = multiscript_text(rng, int(rng.integers(1, W))).encode()[:W]
            raw = raw.decode("utf-8", errors="ignore").encode()
        rows.append(raw)
    by = np.zeros((B, W), np.uint8)
    nb = np.zeros(B, np.int32)
    for b, raw in enumerate(rows):
        by[b, : len(raw)] = np.frombuffer(raw, np.uint8)
        nb[b] = len(raw)
    return torch.from_numpy(by).to(dev), torch.from_numpy(nb).to(dev)


GRID_SHAPES = [(4096, 256), (1024, 1024), (256, 4096), (7, 256), (3, 4064)]


@pytest.mark.parametrize("B,W", GRID_SHAPES)
def test_k1_rows_equals_plain(dev, B, W):
    """K1's row entry (one block per row, planes in shared memory) equals
    its plain version for all four profiles; piece_starts_chars takes it
    for rows of at most 4096 chars."""
    by, nb = _grid(B, W, B + W, dev)
    cp, _, _, m = PT.utf8_decode(by, nb)
    cp[min(5, B - 1), 3] = 0x7FFFFFFF
    for profile in PROFILES:
        before = BP.piece_starts_rows.launches
        got = BP.piece_starts_chars(cp, m, profile=profile, packed_out=True)
        assert BP.piece_starts_rows.launches == before + 1
        want = BP.piece_starts_chars_plain(cp, m, profile=profile)
        torch.cuda.synchronize()
        assert torch.equal(got, want), profile


@pytest.mark.parametrize("B,W", GRID_SHAPES[:3])
def test_grid_stages_equal_plain(dev, B, W):
    """K2+K3 (byte flags, p_cap = W) and K4 (the decode's and finalize's
    compactions) at the grid shapes equal their plain versions."""
    from tokendagger_tpu_torch.ops.fused import finalize_host

    by, nb = _grid(B, W, B * W, dev)
    decoded = PT.utf8_decode(by, nb)
    for g, w in zip(decoded, PT.utf8_decode(by.cpu(), nb.cpu())):
        assert torch.equal(g.cpu(), w)
    cp, cob, _, m = decoded
    st = BP.piece_starts_chars(cp, m)
    stb = PT.starts_to_bytes(st, cob, by, nb)
    keys = CP.compact_piece_keys(stb, by, nb, W)
    want = CP.compact_piece_keys_plain(stb, by, nb, W)
    torch.cuda.synchronize()
    for g, w in zip(keys, want):
        assert torch.equal(g, w)
    rank = torch.where(keys[1] % 3 == 0, -1, keys[2] & 0xFFFF)
    got = finalize_host(keys[0], keys[1], rank, keys[6], nb, p_cap=W)
    ref = finalize_host(*(t.cpu() for t in (keys[0], keys[1], rank,
                                            keys[6], nb)), p_cap=W)
    for g, w in zip(got, ref):
        assert torch.equal(g.cpu(), w)


def test_threads_share_one_engine_on_the_card(dev):
    """Four threads encode short texts (grids) and long ones (windows)
    through one Tokenizer on the card; each gets the host engine's ids."""
    import threading

    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine, Tokenizer

    ranks, specials = make_tiny_vocab()
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, device="cuda")
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    rng = np.random.default_rng(21)
    jobs = [[multiscript_text(rng, int(k)) + "<|bos|>x"
             for k in rng.integers(0, 3000, 40)] for _ in range(12)]
    jobs += [[multiscript_text(rng, 300000)] for _ in range(2)]
    got = [None] * len(jobs)
    errors = []

    def work(t):
        try:
            for i in range(t, len(jobs), 4):
                got[i] = tok.encode_batch(jobs[i], allowed_special="all")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for job, ids in zip(jobs, got):
        assert ids == [host.encode(t, set(specials))[0] for t in job]
    st = tok._get_device().stats
    assert st.grids >= 12 and st.windows >= 2


def _merge_tables(dev):
    from tokendagger_tpu_torch.convert import merge_tables_from_ranks
    from torch_port_util import merge_vocab

    return merge_tables_from_ranks(merge_vocab()[0], device=dev)


def _chain_tables(dev):
    """Merge tables of ranks over all 256 bytes, every run of 2-256 b"a"
    and every prefix of a seeded 256-byte string S without b"a": rows of C
    b"a" and S[:C] merge C - 1 times. Returns (tables, S)."""
    from tokendagger_tpu_torch.convert import merge_tables_from_ranks

    rng = np.random.default_rng(11)
    s = bytes(rng.choice([c for c in range(33, 127) if c != ord("a")],
                         256).astype(np.uint8))
    ranks = {bytes([i]): i for i in range(256)}
    for k in range(2, 257):
        ranks[b"a" * k] = len(ranks)
    for k in range(2, 257):
        ranks[s[:k]] = len(ranks)
    return merge_tables_from_ranks(ranks, device=dev), s


def _edge_rows(rng, R, C, chain):
    """``merge_rows_np``'s rows (R >= 9) with every 8th row from the 9th on
    replaced in turn by: empty, a row of C bytes, one byte, S[:C], C b"a",
    C spaces; so lengths 0 and 1 sit between long rows."""
    from torch_port_util import merge_rows_np

    buf, lens = merge_rows_np(rng, R, C)
    cycle = [b"", bytes(rng.integers(32, 127, C).astype(np.uint8)), b"a",
             chain[:C], b"a" * C, b" " * C]
    for k, r in enumerate(range(9, R, 8)):
        row = cycle[k % len(cycle)]
        buf[r, : len(row)] = np.frombuffer(row, np.uint8)
        lens[r] = len(row)
    return buf, lens


def _held(M, dev, mt, buf, lens, lut):
    """The merge kernel on (buf, lens) against the plain loop; the call
    must count one launch. Returns the counts."""
    by, ln = torch.from_numpy(buf).to(dev), torch.from_numpy(lens).to(dev)
    lut_t = mt.pair_lut if lut else None
    before = M.merge_rows.launches
    tok, cnt = M.merge_rows(by, ln, mt.byte_rank, mt.pair_rows, mt.pair_mask,
                            lut_t)
    torch.cuda.synchronize()
    assert M.merge_rows.launches == before + 1
    want = M.merge_rows_local(by, ln, mt.byte_rank, mt.pair_rows,
                              mask=mt.pair_mask, pair_lut=lut_t)
    assert torch.equal(tok, want[0]) and torch.equal(cnt, want[1])
    return cnt.cpu()


@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("C", [16, 64, 256])
def test_merge_kernel_equals_plain(dev, C, lut):
    """The merge kernel against the plain loop on random and edge rows
    (lengths 0, 1 and C between long rows, equal-byte runs, unranked
    pairs), at R = 700; on edge calls (R = 1, one row past a block at
    each lane count, both sides of the lane-count steps) with rows whose
    merges are chains of C - 1 (a chain vocabulary); and, at C = 64,
    131,072 rows (the sharded text's). Every call counts one launch."""
    from tokendagger_tpu_torch.ops import merge as M
    from torch_port_util import merge_rows_np

    mt = _merge_tables(dev)
    chain_mt, chain = _chain_tables(dev)
    buf, lens = _edge_rows(np.random.default_rng(C), 700, C, chain)
    cnt = _held(M, dev, mt, buf, lens, lut)
    assert int((cnt < torch.from_numpy(lens)).sum()) > 100     # merged
    for R in (1, 9, 2048, 2049, 4097, 8192, 8193, 8257):
        buf, lens = _edge_rows(np.random.default_rng(R + C), max(R, 9), C,
                               chain)
        for tables in (mt, chain_mt):
            cnt = _held(M, dev, tables, buf[-R:], lens[-R:], lut)
        if R > 41:       # rows 33 and 41, S[:C] and C b"a": one token each
            assert int(cnt[33]) == int(cnt[41]) == 1
    if C == 64:
        buf, lens = merge_rows_np(np.random.default_rng(64), 131072, 64)
        _held(M, dev, mt, buf, lens, lut)


def test_merge_kernel_in_a_mostly_empty_window(dev):
    """resolve_window(miss_mode="device") on a 64 KB window of prose whose
    pieces are in the vocabulary but three rare identifiers: the merge
    buckets are almost empty, every merge call launches once (three a
    window), and the ids equal the CPU's."""
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine
    from tokendagger_tpu_torch.convert import merge_tables_from_ranks
    from tokendagger_tpu_torch.ops import merge as M
    from tokendagger_tpu_torch.ops.fused import caps_for, resolve_window
    from tokendagger_tpu_torch.tables import build_vhash8

    n = 1 << 16
    rng = np.random.default_rng(5)
    ranks, specials = make_tiny_vocab()
    text = prose_text(rng, n - 2000)
    plain = HostEngine(LLAMA4_PATTERN, {bytes([i]): i for i in range(256)},
                       {})
    for a, b in plain.split_spans(text):
        p = text[a:b].encode()
        for k in range(2, len(p) + 1):
            ranks.setdefault(p[:k], len(ranks))
    text = " ".join([text, "zqxjkv", "qqzzxxjjvvkk" * 4, "xq" * 100, "end"])
    raw = text.encode()
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    starts = np.zeros(n, bool)
    for a, _ in host.split_spans(text):
        starts[a] = True
    boc = np.full(n, len(raw), np.int32)
    boc[: len(raw)] = np.arange(len(raw))        # ASCII: a byte a char
    data = np.zeros(n, np.uint8)
    data[: len(raw)] = np.frombuffer(raw, np.uint8)
    vh, vmask, _ = build_vhash8(ranks)
    out, rows = {}, {}
    for d in ("cpu", dev):
        mt = merge_tables_from_ranks(ranks, device=d)
        args = [torch.from_numpy(x)[None].to(d) for x in (starts, boc, data)]
        args += [torch.tensor([v], dtype=torch.int32, device=d)
                 for v in (len(raw), len(raw))]
        rows[d] = {}
        before = M.merge_rows.launches
        out[d] = resolve_window(
            *args, mt.byte_rank, mt.pair_rows, mt.pair_lut, mt.vk, mt.vlen,
            mt.vrank, torch.as_tensor(vh, device=d), mask=mt.pair_mask,
            vhash_mask=vmask, miss_mode="device", rows_out=rows[d],
            **caps_for(n))
        torch.cuda.synchronize()
        assert M.merge_rows.launches == before + (3 if d != "cpu" else 0)
    for g, w in zip(out[dev], out["cpu"]):
        assert torch.equal(g.cpu(), w)
    caps = caps_for(n)
    n_rows = {w: int(v.sum()) for w, v in rows["cpu"].items()}
    assert 0 < sum(n_rows.values()) <= 8, n_rows
    assert n_rows[16] < caps["m16"] // 100 and n_rows[64] < caps["m64"] // 10


def test_resolve_window_card_equals_cpu(dev):
    """resolve_window on the card (K2+K3, K4 and the merge kernel) equals
    its CPU run, both miss modes and both joins."""
    from tokendagger_tpu_torch.convert import merge_tables_from_ranks
    from tokendagger_tpu_torch.ops.fused import caps_for, resolve_window
    from tokendagger_tpu_torch.tables import build_vhash8
    from torch_port_util import fused_window

    ranks, _, starts, boc, data, nbytes, trim = fused_window(3)
    N = data.shape[0]
    vh, vmask, _ = build_vhash8(ranks)
    out = {}
    for d in ("cpu", dev):
        mt = merge_tables_from_ranks(ranks, device=d)
        args = [torch.from_numpy(x)[None].to(d) for x in (starts, boc, data)]
        args += [torch.tensor([v], dtype=torch.int32, device=d)
                 for v in (nbytes, trim)]
        for miss in ("host", "device"):
            for join in ("probe", "sort"):
                out[d, miss, join] = resolve_window(
                    *args, mt.byte_rank, mt.pair_rows, mt.pair_lut, mt.vk,
                    mt.vlen, mt.vrank, torch.as_tensor(vh, device=d),
                    mask=mt.pair_mask, vhash_mask=vmask, join_mode=join,
                    miss_mode=miss, **caps_for(N))
    for (d, miss, join), got in out.items():
        if d == "cpu":
            continue
        for g, w in zip(got, out["cpu", miss, join]):
            assert torch.equal(g.cpu(), w), (miss, join)
    assert int(out["cpu", "device", "probe"][8]) == 1   # the 300-byte piece


def test_cuda_tensors_never_reach_the_plain_merge(dev, monkeypatch):
    """merge_rows, resolve_window and the piece path on CUDA tensors run
    the kernel: the plain loop raises if reached."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine, HostEngine
    from tokendagger_tpu_torch.ops import merge as M
    from torch_port_util import merge_rows_np, merge_vocab

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain merge")

    monkeypatch.setattr(M, "merge_rows_local", refuse)
    monkeypatch.setattr(M, "merge_rows_from_state", refuse)
    mt = _merge_tables(dev)
    buf, lens = merge_rows_np(np.random.default_rng(1), 64, 64)
    M.merge_rows(torch.from_numpy(buf).to(dev),
                 torch.from_numpy(lens).to(dev), mt.byte_rank, mt.pair_rows,
                 mt.pair_mask)
    with pytest.raises(AssertionError, match="plain merge"):
        M.merge_rows(torch.from_numpy(buf), torch.from_numpy(lens),
                     mt.byte_rank.cpu(), mt.pair_rows.cpu(), mt.pair_mask)
    ranks, specials = merge_vocab()
    text = multiscript_text(np.random.default_rng(2), 12000)
    want = HostEngine(LLAMA4_PATTERN, ranks, specials).encode_ordinary(text)
    for stream, miss in ((False, "host"), (True, "device")):
        eng = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device=dev,
                           stream=stream, vocab_fastpath=False)
        eng.miss_mode = miss
        before = M.merge_rows.launches
        assert eng.encode_ordinary_batch([text])[0] == want
        assert M.merge_rows.launches > before


# ---------------------------------------------------------------------------
# The rest of ops/pretokenize, the plain compactions and run_resident's
# single-window pipeline on the card
# ---------------------------------------------------------------------------


def _cp_windows(seed: int, n: int):
    """(2, n) int32 codepoints of seeded multi-script text (one window
    full, one cut short) with random codepoints beyond, and the counts."""
    rng = np.random.default_rng(seed)
    cp = rng.integers(0, 0x110000, (2, n)).astype(np.int32)
    m = np.array([n, n - 12345], np.int32)
    for b in range(2):
        text = multiscript_text(rng, n + 64)
        c = np.frombuffer(text.encode("utf-32-le"), np.uint32)[: m[b]]
        cp[b, : m[b]] = c.astype(np.int32)
    return torch.from_numpy(cp), torch.from_numpy(m)


@pytest.mark.parametrize("profile", PROFILES + ["o999k_unknown"])
def test_compute_starts_card_equals_char_form(dev, profile):
    """compute_starts on the card (K1's codepoint entry; for another
    profile match_lengths and chain_starts in plain torch) against the
    char form on the CPU, at 64 K chars."""
    from tokendagger_tpu_torch.unicode_tables import get_two_level_tables

    page_ids, pages = get_two_level_tables()
    cp, m = _cp_windows(21, 1 << 16)
    before = BP.piece_starts_chars.launches
    got = PT.compute_starts(cp.to(dev), m.to(dev), page_ids, pages,
                            profile=profile)
    if profile in PROFILES:
        assert BP.piece_starts_chars.launches == before + 1
        want = PT.piece_starts(cp, m, page_ids, pages, profile=profile)
    else:
        want = PT.chain_starts(PT.match_lengths(cp, m, page_ids, pages,
                                                profile=profile), m)
    assert torch.equal(got.cpu(), want)
    lens = PT.match_lengths(cp.to(dev), m.to(dev), page_ids, pages,
                            profile=profile)
    assert torch.equal(PT.chain_starts(lens, m.to(dev)).cpu(), want)


def test_sorted_compactions_card_equal_cpu(dev):
    """The sorted and ASCII decodes, join.compact_piece_keys(_sorted) and
    finalize_host_sorted on the card equal their CPU runs."""
    from tokendagger_tpu_torch.ops import fused as FU
    from tokendagger_tpu_torch.ops import join as J

    n = 1 << 16
    rng = np.random.default_rng(22)
    texts = [multiscript_text(rng, n), prose_text(rng, n - 999), "", "x"]
    by, nb = stage(texts, n, rng)
    out = {}
    for d in ("cpu", dev):
        x, y = torch.from_numpy(by).to(d), torch.from_numpy(nb).to(d)
        cp, cob, boc, m = PT.utf8_decode_sorted(x, y)
        st = PT.piece_starts(cp.cpu(), m.cpu(), *_two_level()).to(d)
        p_cap = 21888
        keys = J.compact_piece_keys(st, boc, x, y, p_cap)
        stb = PT.starts_to_bytes(st, cob, x, y)
        keys_s = J.compact_piece_keys_sorted(stb, x, y, p_cap)
        rank = torch.where(keys_s[1] % 3 == 0, -1, keys_s[1] * 7)
        fins = [FU.finalize_host_sorted(*keys_s[:2], rank, keys_s[6], t,
                                        p_cap=p_cap, untrimmed=u)
                for t, u in ((n, True), (n // 2, False))]
        out[str(d)] = [PT.utf8_decode_ascii(x, y), (cp, cob, boc, m), keys,
                       keys_s] + fins
    for got, want in zip(out[str(dev)], out["cpu"]):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert int(out["cpu"][3][6][0]) > 10000        # pieces of window 0


def _two_level():
    from tokendagger_tpu_torch.unicode_tables import get_two_level_tables

    return get_two_level_tables()


@pytest.mark.parametrize("kw", [
    dict(impl="auto"), dict(impl="scatter"), dict(impl="auto", ascii=True),
    dict(miss_mode="device"), dict(miss_mode="device", join_mode="sort"),
])
def test_single_window_resident_on_card(dev, kw):
    """run_resident(batch=1) on the card: ids equal to the host engine,
    device stage times, and its kernels launched."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, run_resident
    from tokendagger_tpu_torch.ops import merge as M
    from torch_port_util import merge_vocab

    kw = dict(kw)
    rng = np.random.default_rng(23)
    if kw.pop("ascii", False):
        corpus = prose_text(rng, 3 * 32768).encode()
    else:
        corpus = "".join(prose_text(rng, 2000) + multiscript_text(rng, 400)
                         for _ in range(48)).encode()
    ranks, specials = merge_vocab()
    counters = (PT.utf8_decode_block, BP.piece_starts_chars,
                CP.compact_by_mask, CP.compact_piece_keys, M.merge_rows)
    for k in counters:
        k.launches = 0
    r = run_resident(ranks, specials, LLAMA4_PATTERN, corpus, window=32768,
                     n_windows=3, reps=4, device=dev, **kw)
    n = {k.__name__: k.launches for k in counters}
    assert r.match_host and r.overflow_windows == 0 and r.batch == 1
    assert r.starts_impl == "jnp" and r.compact_impl == "sort"
    assert r.device_ms > 0 and r.overlap is None
    stages = ({"decode", "starts", "resolve"} if "miss_mode" in kw
              else {"decode", "starts", "compact", "probe", "finalize"})
    assert set(r.stage_us) == stages
    # every run launches K1; the scatter decode K9 and K4 (decode and
    # finalize_host); resolve_window K2+K3, K4 and the merge (after the
    # sorted decode, which launches no kernel)
    assert n["piece_starts_chars"] >= 6
    if r.impl == "scatter":
        assert n["utf8_decode_block"] >= 6 and n["compact_by_mask"] >= 12
    if "miss_mode" in kw:
        assert n["utf8_decode_block"] == 0 and n["compact_by_mask"] >= 6
        assert n["compact_piece_keys"] >= 6 and n["merge_rows"] >= 6


@pytest.mark.parametrize("kw", [
    dict(batch=2, n_windows=2, cap_bytes_per_piece=0, probe_impl="chunks"),
    dict(impl="auto"), dict(miss_mode="device"),
])
def test_resident_device_time_from_trace(dev, kw):
    """run_resident's stage_us and device_ms come from a profiler trace
    that holds one kernel event for every launch of each hand-written
    kernel, and that sum to at most the event time of the same stages
    (which includes the card's waits for the host)."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, run_resident
    from torch_port_util import merge_vocab

    rng = np.random.default_rng(29)
    corpus = "".join(prose_text(rng, 2000) + multiscript_text(rng, 400)
                     for _ in range(48)).encode()
    ranks, specials = merge_vocab()
    r = run_resident(ranks, specials, LLAMA4_PATTERN, corpus, window=32768,
                     reps=4, overlap_trial=False, device=dev,
                     **{"n_windows": 3, **kw})
    assert r.match_host and r.overflow_windows == 0
    assert r.trace_kernels and r.trace_kernel_shortfall == {}
    for name, c in r.trace_kernels.items():
        assert c["events"] == c["launches"] > 0, name
    assert set(r.stage_us) == set(r.event_us)
    assert 0 < r.device_ms <= r.event_ms


def _mesh_case(seed: int):
    """A reachable vocabulary (tiny), an 11 KB multi-script text and the
    mesh pipeline's general+hot configuration on 4 windows of 32 KB."""
    from conftest import make_tiny_vocab
    import torch_resident_mesh_util as U

    ranks = make_tiny_vocab()[0]
    rng = np.random.default_rng(seed)
    text = (multiscript_text(rng, 6000) + prose_text(rng, 5000)).encode()
    cfgs = U.configs(ranks, seed)
    return ranks, text, cfgs, U


def test_sharded_text_one_rank_nccl_equals_host(dev):
    """get_mesh(1) on the card: one NCCL rank; ShardedTextEncoder at
    2 KB shards equals the host engine and the CPU mesh."""
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine, HostEngine
    from tokendagger_tpu_torch.parallel.mesh import get_mesh
    from tokendagger_tpu_torch.parallel.sharded_text import ShardedTextEncoder

    ranks = make_tiny_vocab()[0]
    rng = np.random.default_rng(21)
    text = multiscript_text(rng, 30000) + prose_text(rng, 30000)
    mesh = get_mesh(1)
    assert mesh.device.type == "cuda" and mesh.size == 1
    outs = []
    for m, d in ((mesh, mesh.device), (get_mesh(1, device="cpu"), "cpu")):
        eng = DeviceEngine(LLAMA4_PATTERN, ranks, {}, device=d)
        st = ShardedTextEncoder(eng, m, shard_bytes=2048, halo=512)
        outs.append((st.encode(text.encode()).tolist(), st.passes,
                     st.fallbacks))
    assert outs[0] == outs[1]
    assert outs[0][0] == HostEngine(LLAMA4_PATTERN, ranks,
                                    {}).encode_ordinary(text)


@pytest.mark.parametrize("name", ["ascii", "general+hot"])
def test_mesh_pipeline_card_equals_cpu(dev, name):
    """mesh_resident_pipeline over get_mesh(1) on the card (K1, K2+K3,
    K4; K9, K5-K8 on the general path) equals the same pipeline on the
    CPU, all 11 outputs."""
    from tokendagger_tpu_torch.convert import tables_from_ranks
    from tokendagger_tpu_torch.parallel.mesh import get_mesh, shard_rows
    from tokendagger_tpu_torch.parallel.resident_mesh import (
        mesh_resident_pipeline,
    )

    ranks, _, cfgs, U = _mesh_case(3)
    kw, wins, nbs = cfgs[name]
    outs = []
    for mesh in (get_mesh(1), get_mesh(1, device="cpu")):
        fn = mesh_resident_pipeline(
            mesh, tables_from_ranks(ranks, device=mesh.device), None, None,
            window=U.WINDOW, p_cap=U.P_CAP, **kw)
        outs.append([x.cpu().numpy()
                     for x in fn(*shard_rows(mesh, wins, nbs))])
    U.assert_equal(*outs)
    U.assert_host(ranks, cfgs[name], outs[0])


def test_mesh_two_cards_equal_cpu(dev, tmp_path):
    """Two ranks on two cards over NCCL: the sharded text's ids and the
    mesh pipeline's outputs equal one CPU rank's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    import torch_mesh_workers
    from tokendagger_tpu_torch import LLAMA4_PATTERN, HostEngine

    ranks, text, cfgs, U = _mesh_case(4)
    names = ("ascii", "general+hot")
    pair = torch_mesh_workers.spawn(
        2, tmp_path, "card_pair", ranks=ranks, text=text, window=U.WINDOW,
        p_cap=U.P_CAP, configs=[cfgs[n] for n in names])
    want = HostEngine(LLAMA4_PATTERN, ranks, {}).encode_ordinary(
        text.decode())
    for r in pair:
        assert r["ids"].tolist() == want and r["fallbacks"] == 0
    for i, n in enumerate(names):
        got = [np.concatenate([a, b]) for a, b in zip(
            pair[0]["mesh"][i][:9], pair[1]["mesh"][i][:9])] + list(
            pair[0]["mesh"][i][9:])
        U.assert_equal(got, U.port_d1(ranks, cfgs[n]))


# ---------------------------------------------------------------------------
# The whole-piece probe kernel (csrc/probe.cu)
# ---------------------------------------------------------------------------


def _probe_table(seed: int, n: int = 200_000):
    """A vhash8 table of n seeded pieces of 1-16 bytes (2^18 buckets at
    200,000, as Llama-4's), built by _build_vocab_hash8: (rows, mask, the
    pieces' (n, 4) uint32 words and lengths, and the indices of the pieces
    the table answers, not dropped from a full bucket)."""
    from tokendagger_tpu_torch.ops.join import vocab_probe8_np
    from tokendagger_tpu_torch.tables import _build_vocab_hash8

    rng = np.random.default_rng(seed)
    ln = rng.integers(1, 17, n).astype(np.int32)
    by = rng.integers(0, 256, (n, 16)).astype(np.uint8)
    by[np.arange(16)[None, :] >= ln[:, None]] = 0
    qk = by.view("<u4").reshape(n, 4).copy()
    rk = rng.permutation(n).astype(np.int32)
    rows, mask, _ = _build_vocab_hash8(qk, ln, rk)
    found = np.flatnonzero(vocab_probe8_np(qk, ln, rows, mask) >= 0)
    return rows, mask, qk, ln, found


def _probe_queries(shape, seed, table):
    """(k0, k1, k2, k3, len) int32 arrays of ``shape``: ~55% the table's
    pieces, ~30% random words of lengths -1-40, the rest dead (length 0,
    zero keys); the first rows (or, for one row, the first spans) are edge
    cases: all dead, all hits, the fullest bucket's pieces (some dropped),
    and length -1 with zero keys."""
    from tokendagger_tpu_torch.tables import _mix_hash, _vhash_ab

    rows, mask, qk, ln, found = table
    rng = np.random.default_rng(seed)
    P = int(np.prod(shape))
    pick = rng.integers(0, len(ln), P)
    words = qk[pick].copy()
    lens = ln[pick].copy()
    kind = rng.random(P)
    wild = kind > 0.55
    words[wild] = rng.integers(0, 2**32, (int(wild.sum()), 4),
                               dtype=np.uint64).astype(np.uint32)
    lens[wild] = rng.integers(-1, 41, int(wild.sum()))
    dead = kind > 0.85
    words[dead], lens[dead] = 0, 0
    h = _mix_hash(*_vhash_ab(qk[:, 0], qk[:, 1], qk[:, 2], qk[:, 3], ln), 0,
                  mask)
    full = np.flatnonzero(h == np.bincount(h).argmax())
    span = max(1, min(P // 4, shape[-1]))
    edges = [(np.zeros((span, 4), np.uint32), np.zeros(span, np.int32)),
             (qk[np.resize(found, span)], ln[np.resize(found, span)]),
             (qk[np.resize(full, span)], ln[np.resize(full, span)]),
             (np.zeros((span, 4), np.uint32), np.full(span, -1, np.int32))]
    for e, (w, n) in enumerate(edges):
        at = slice(e * span, (e + 1) * span)
        if at.stop <= P:
            words[at], lens[at] = w, n
    wi = words.view(np.int32)
    return [wi[:, j].reshape(shape).copy() for j in range(4)] + [
        lens.reshape(shape)]


@pytest.fixture(scope="module")
def probe_table():
    return _probe_table(0)


@pytest.mark.parametrize("shape", [(8, 349_568), (1, 1_398_144), (256, 4096),
                                   (8, 91_776), (3, 5), (1, 1)])
def test_probe_kernel_equals_plain(dev, probe_table, shape):
    """td_vocab_probe8 equals vocab_probe8_plain at the stream batch's and
    the engine window's capacities, a grid shape and the hot route's dense
    prefix, and on short calls, with edge rows: all dead, all hits, the
    fullest bucket, length -1 with zero keys."""
    from tokendagger_tpu_torch.ops import join as J

    rows = torch.from_numpy(probe_table[0]).to(dev)
    mask = probe_table[1]
    q = [torch.from_numpy(x).to(dev)
         for x in _probe_queries(shape, sum(shape), probe_table)]
    before = J.vocab_probe8.launches
    got = J.vocab_probe8(*q, rows, mask)
    assert J.vocab_probe8.launches == before + 1
    want = J.vocab_probe8_plain(*q, rows, mask)
    torch.cuda.synchronize()
    assert got.shape == want.shape == shape and got.dtype == torch.int32
    assert torch.equal(got, want.to(torch.int32))
    if shape[0] >= 4:
        assert (got[0] == -1).all() and (got[1] >= 0).all()
        assert (got[2] == -1).any() and (got[3] == 0).any()


def test_cuda_tensors_never_reach_the_plain_probe(dev, monkeypatch):
    """vocab_probe8 and its callers on CUDA tensors (the engine's windows,
    the grids, run_resident's batched pipeline with and without the hot
    route's dense prefix) run the kernel: the plain version raises if
    reached."""
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import (
        LLAMA4_PATTERN, HostEngine, Tokenizer, run_resident,
    )
    from tokendagger_tpu_torch.ops import join as J

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain probe")

    monkeypatch.setattr(J, "vocab_probe8_plain", refuse)
    with pytest.raises(AssertionError, match="plain probe"):
        z = torch.zeros(4, dtype=torch.int32)
        J.vocab_probe8(z, z, z, z, z, torch.zeros((1024, 48),
                                                  dtype=torch.int32), 1023)
    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(3)
    text = multiscript_text(rng, 30000)
    short = [multiscript_text(rng, int(k)) for k in rng.integers(5, 300, 40)]
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, device=dev)
    before = J.vocab_probe8.launches
    assert tok.encode_ordinary(text) == host.encode_ordinary(text)
    assert tok.encode_batch(short) == [host.encode_ordinary(t)
                                       for t in short]
    assert J.vocab_probe8.launches >= before + 2
    corpus = multiscript_text(rng, 2 * 32768).encode()
    for cap in (3.0, 0):
        before = J.vocab_probe8.launches
        r = run_resident(ranks, specials, LLAMA4_PATTERN, corpus,
                         window=32768, n_windows=2, batch=2, reps=1,
                         cap_bytes_per_piece=cap, probe_impl="chunks",
                         overlap_trial=False, device=dev)
        assert r.match_host and r.overflow_windows == 0
        assert J.vocab_probe8.launches > before


def test_probe_on_a_second_card(dev, probe_table):
    """The probe runs on its tensors' card: cuda:1 while cuda:0 is the
    current card, against the CPU."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from tokendagger_tpu_torch.ops import join as J

    q = _probe_queries((4, 5000), 11, probe_table)
    want = J.vocab_probe8(*map(torch.from_numpy, q),
                          torch.from_numpy(probe_table[0]), probe_table[1])
    with torch.cuda.device(0):
        d1 = torch.device("cuda:1")
        got = J.vocab_probe8(*(torch.from_numpy(x).to(d1) for x in q),
                             torch.from_numpy(probe_table[0]).to(d1),
                             probe_table[1])
        assert got.device == d1
        assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# kimi (Kimi K2's pattern): K1's Han rules and the Tokenizer on the card
# ---------------------------------------------------------------------------


def _kimi_windows(seed, B, n, full=False):
    """B windows of n codepoint slots of Han-heavy text (garbage past each
    window's length): ragged lengths, an empty window, or all full."""
    from torch_port_util import han_text

    rng = np.random.default_rng(seed)
    lengths = ([n] * B if full else
               [min(k, n) for k in (n - 77, 0, n // 3 + 5, n, 33, n - 1,
                                    1000, n // 2)][:B])
    cp = rng.integers(0, 0x110000, (B, n)).astype(np.int32)
    for b, k in enumerate(lengths):
        cp[b, :k] = [ord(c) for c in han_text(rng, k)]
    return cp, np.array(lengths, np.int32)


@pytest.mark.parametrize("B,n", [(1, 1 << 16), (8, 1 << 16), (1, 1 << 22)])
def test_k1_kimi_equals_plain(dev, B, n):
    """K1 under kimi (han_prepass, then derive_o200k<true>): its codepoint
    and class-word entries spread over many blocks equal the plain
    version on Han-heavy windows, up to the engine's 4 MB window."""
    cp, m = _kimi_windows(B + n, B, n, full=n > 1 << 16)
    words = BP.char_class_words("kimi")[cp].astype(np.int32)
    xs = torch.from_numpy(cp).to(dev)
    ms = torch.from_numpy(m).to(dev)
    want = BP.piece_starts_chars_plain(xs, ms, profile="kimi")
    got = BP.piece_starts_chars(xs, ms, profile="kimi", packed_out=True)
    ws = torch.from_numpy(words).to(dev)
    got_w = BP.piece_starts_words(ws, ms, profile="kimi")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_w, want)
    if n <= 1 << 16:  # the plain version on the card is the CPU's
        assert torch.equal(want.cpu(), BP.piece_starts_chars_plain(
            xs.cpu(), ms.cpu(), profile="kimi"))


@pytest.mark.parametrize("B,W", GRID_SHAPES)
def test_k1_rows_kimi_equals_plain(dev, B, W):
    """K1's row entry under kimi equals its plain version on Han-heavy
    rows (the grids' rows and the engine's 4 KB window)."""
    cp, m = _kimi_windows(B * W, min(B, 8), W)
    cp = np.tile(cp, (-(-B // len(cp)), 1))[:B]
    m = np.tile(m, -(-B // len(m)))[:B]
    xs, ms = torch.from_numpy(cp).to(dev), torch.from_numpy(m).to(dev)
    before = BP.piece_starts_rows.launches
    got = BP.piece_starts_chars(xs, ms, profile="kimi", packed_out=True)
    assert BP.piece_starts_rows.launches == before + 1
    want = BP.piece_starts_chars_plain(xs, ms, profile="kimi")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kimi_tokenizer_card_equals_reference(dev):
    """Tokenizer(pat_str=KIMI_PATTERN, backend="device") on the card: its
    ids equal the benchmark's plain reference on 7 MB of Han-heavy text
    with specials (its three sub-documents one batch of windows, then 4 MB
    windows cut at safe offsets) and on a batch of short texts (grids);
    every boundary comes from K1, none from ``regex``."""
    import sys

    from tokendagger_tpu_torch import KIMI_PATTERN, Tokenizer
    from torch_port_util import han_text

    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from tdbench.reference.encode import Reference
    from tdbench.standin import standin_ranks

    config = {"pat_str": KIMI_PATTERN, "n_mergeable_ranks": 60000,
              "assumed": {"sample_bytes": {"prose": 1 << 16,
                                           "code": 1 << 13}}}
    ranks = standin_ranks(config, 2**31 + 5)
    specials = {"[BOS]": 60000, "[EOS]": 60001, "<|im_end|>": 60002}
    tok = Tokenizer("kimi", pat_str=KIMI_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, backend="device", device=dev)
    assert tok._get_device().host._re is None  # no regex split anywhere
    ref = Reference(KIMI_PATTERN, ranks, specials)
    rng = np.random.default_rng(21)
    text = "[EOS]".join(han_text(rng, 1 << 18) for _ in range(3))
    text = text + "<|im_end|>" + han_text(rng, 1 << 21)
    assert len(text.rsplit("<|im_end|>", 1)[1].encode()) > 1 << 22
    assert tok.encode(text, allowed_special="all") == ref.encode(text)
    stats = tok._device.stats
    assert stats.cut_windows >= 1 and stats.spliced_han >= 1
    assert stats.host_advance_windows == 0
    # the three sub-documents in one batch; each later window alone
    assert stats.windows - stats.window_batches == 3 - 1
    short = [han_text(rng, int(k)) for k in rng.integers(1, 1200, 40)]
    assert tok.encode_batch(short, allowed_special="all") == [
        ref.encode(t) for t in short]
    assert stats.grid_rows >= 40
