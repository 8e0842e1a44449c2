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


@pytest.mark.parametrize("packed", [False, True])
def test_k2k3_equals_plain(dev, packed):
    n = 1 << 15
    by, nb = _windows(3, n, dev)
    words = BP.piece_starts_bits(by, nb)
    flags = words if packed else BP.unpack_mask(words)
    p_cap = n // 3 // 128 * 128
    got = CP.compact_piece_keys(flags, by, nb, p_cap, packed=packed)
    want = CP.compact_piece_keys_plain(flags, by, nb, p_cap, packed=packed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[6].max()) > p_cap  # the overflow window


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


# ---------------------------------------------------------------------------
# The general pipeline's kernels: K5+K6, K7+K8, K1's class-word entry
# ---------------------------------------------------------------------------


def _route_masks(dev, B, N, cap, seed):
    """Rows: random 30%, skewed (empty first half), empty, all kept (an
    overflow when cap < N), random 60%, random 5%."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand((B, N), generator=g, device=dev) < 0.3
    mask[1, : N // 2] = False
    mask[2] = False
    mask[3] = True
    mask[4] = torch.rand((N,), generator=g, device=dev) < 0.6
    mask[5] = torch.rand((N,), generator=g, device=dev) < 0.05
    return mask, g


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("N,cap", [(100, 64), (65536, 32768), (70001, 90000),
                                   (1 << 20, 655360)])
def test_k5k8_equals_plain(dev, k, N, cap):
    B = 6
    mask, g = _route_masks(dev, B, N, cap, N + k)
    arrays = [torch.randint(-2**31, 2**31 - 1, (B, N), generator=g,
                            device=dev, dtype=torch.int32) for _ in range(k)]
    for fill in (0, -1):
        got = CP.compact_record(arrays, mask, cap=cap, fill=fill)
        want = CP.compact_record_plain(arrays, mask, cap=cap, fill=fill)
        torch.cuda.synchronize()
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
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
