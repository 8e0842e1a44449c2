"""The kimi profile (Kimi K2's pattern) on the CPU: its classification, the
frozen Han plane against tiktoken and the benchmark's Han table, the four
other profiles' class tables unchanged, K1's Han rules (the plain version
and the host build of csrc/starts_derive.cuh) against the reference split,
``Tokenizer`` through every route against tiktoken and the benchmark's
reference, the counter of spliced Han pieces, the safe cut, the entry
points that refuse the profile, and the ``regex`` V1 fallback (F8)."""

import ctypes
import hashlib
import json
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import torch

import tokendagger_tpu_torch as tt
from tokendagger_tpu_torch import native, scanner_ref
from tokendagger_tpu_torch.engine import DeviceEngine, EngineStats
from tokendagger_tpu_torch.hostengine import HostEngine
from tokendagger_tpu_torch.ops import bitplane as BP
from tokendagger_tpu_torch.ops import pretokenize as PT
from tokendagger_tpu_torch.streaming import coarse_classes
from tokendagger_tpu_torch.unicode_tables import (
    CLASS_WORD_BITS, char_class_words, han_plane, kimi_classes,
)
from torch_port_util import han_text

ROOT = Path(__file__).resolve().parents[1]
KIMI = tt.KIMI_PATTERN

# sha256 of char_class_words(profile) before the kimi profile came
CLASS_WORDS_SHA = {
    "llama4": "e28bcb692a838d81eba5315b44215ff9b852ee649b2df1b8b7dc61f496f24261",
    "nocontract":
    "96fa0b59f360502a16770648cb9342a14054c612d8e7260a28bc4192e5a79ad2",
    "cl100k": "e28bcb692a838d81eba5315b44215ff9b852ee649b2df1b8b7dc61f496f24261",
    "gpt2": "8e1da92a29a4451efda6c6906a89932e15aeb5dfb5b1b20006fbc286e3e517f0",
}

# where Kimi K2's split differs from o200k's, and the Han chars that other
# pieces run into (each against the reference split, below)
EDGES = [
    "  中", "，中", " 中", "!⺀中", "⺀中!", " ⺀⺀x", "\t⺀", "12〇", "1234〇",
    "〇12", "2024〇年", "1〇〇〇〇2〇〇〇〇3", "1〇2〇3〇4", "⺀'s", "中's",
    "中́⺀", "!́⺀", "!!́⺀x", "⺀!́⺀!", "!\n/", "a!\n/x",
    "\"\n//", "Hello world, 你好世界！", "\U00016fe2\U00016ff0中", "々々〻",
    "x\U00016ff0y", "中\U0002ebf0中", "ABc中DEf", " 　中　 x", "",
]


def _tiktoken():
    return pytest.importorskip("tiktoken")


def _bench_han_text(seed: int, n: int) -> str:
    """n chars of the benchmark's Han-heavy test text (the recipe of
    ``tdbench/tests/test_tdbench_pretok_scripts.han_text``)."""
    sys.path.insert(0, str(ROOT / "tdbench" / "tests"))
    try:
        from test_tdbench_pretok_scripts import han_text as bench_han_text
    finally:
        sys.path.pop(0)
    return bench_han_text(n, seed)[:n]


def _cps(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), np.uint32).astype(
        np.int64)


def _want_starts(text: str) -> np.ndarray:
    """Start flags of Kimi K2's split as ``regex`` V1 gives it."""
    regex = pytest.importorskip("regex")
    flags = np.zeros(len(text), bool)
    at = 0
    for p in regex.compile(KIMI, regex.V1).findall(text):
        flags[at] = True
        at += len(p)
    assert at == len(text)
    return flags


# ---------------------------------------------------------------------------
# profile and tables
# ---------------------------------------------------------------------------


def test_classification():
    config = json.loads((ROOT / "tdbench" / "configs" /
                         "kimi_k2.json").read_text())
    assert config["pat_str"] == KIMI
    assert tt.classify_pattern(KIMI) == "kimi"
    assert tt.classify_pattern(tt.LLAMA4_PATTERN) == "llama4"
    assert tt.classify_pattern(KIMI.replace("[\\p{Han}]+|", "")) is None


def test_han_plane_equals_tiktoken():
    """tiktoken's ``\\p{Han}`` over every code point but the surrogates:
    under the pattern ``\\p{Han}`` only Han chars are encoded."""
    tiktoken = _tiktoken()
    enc = tiktoken.Encoding("han", pat_str=r"\p{Han}",
                            mergeable_ranks={bytes([b]): b
                                             for b in range(256)},
                            special_tokens={})
    text = "".join(chr(c) for c in range(0x110000)
                   if not 0xD800 <= c <= 0xDFFF)
    got = bytes(enc.encode_ordinary(text)).decode()
    want = np.zeros(0x110000, bool)
    want[[ord(c) for c in got]] = True
    assert np.array_equal(han_plane(), want)
    assert han_plane().sum() == 99030


def test_han_plane_equals_the_benchmark_table():
    """On the code points Unicode 15.0 assigns the plane is the benchmark's
    ``scripts.HAN``; above 15.0 it adds Extension I alone."""
    from tdbench.reference.scripts import HAN

    ref = np.zeros(0x110000, bool)
    for a, b in HAN:
        ref[a : b + 1] = True
    assigned = np.array([unicodedata.category(chr(c)) != "Cn"
                         for c in range(0x110000)])
    plane = han_plane()
    assert np.array_equal(plane & assigned, ref)
    extra = np.flatnonzero(plane & ~assigned)
    assert extra[0] == 0x2EBF0 and extra[-1] == 0x2EE5D
    assert len(extra) == 0x2EE5D - 0x2EBF0 + 1


@pytest.mark.parametrize("profile", sorted(CLASS_WORDS_SHA))
def test_other_profiles_class_words_unchanged(profile):
    words = char_class_words(profile)
    assert hashlib.sha256(words.tobytes()).hexdigest() == (
        CLASS_WORDS_SHA[profile])


def test_kimi_class_words():
    """llama4's words with Han apart: the han bit on Han alone, no UC or LC
    there, and a punctuation tail class without "/"."""
    bit = {n: 1 << i for i, n in enumerate(CLASS_WORD_BITS)}
    k = char_class_words("kimi").astype(np.int64)
    ll = char_class_words("llama4").astype(np.int64)
    han = han_plane()
    assert np.array_equal((k & bit["han"]) != 0, han)
    assert not (k[han] & (bit["uc"] | bit["lc"])).any()
    assert not k[ord("/")] & bit["rnsl"]
    keep = ~(bit["uc"] | bit["lc"] | bit["han"])
    same = ll.copy()
    same[ord("/")] &= ~bit["rnsl"]
    assert np.array_equal(k & keep, same & keep)
    assert np.array_equal(k[~han], same[~han])
    classes = kimi_classes()
    assert np.array_equal((classes & 0x40) != 0, han)


# ---------------------------------------------------------------------------
# K1 under kimi
# ---------------------------------------------------------------------------


def _window(texts: list[str], n: int):
    """(B, n) int32 codepoints with garbage past each text, and (B,)
    lengths."""
    rng = np.random.default_rng(n)
    cp = rng.integers(0, 0x110000, (len(texts), n)).astype(np.int32)
    m = np.zeros(len(texts), np.int32)
    for b, t in enumerate(texts):
        c = _cps(t)[:n]
        cp[b, : len(c)] = c
        m[b] = len(c)
    return cp, m


def _host_k1(entry: str, x: np.ndarray, m: np.ndarray, S: int):
    from tokendagger_tpu_torch._build import host_library

    fn = getattr(host_library("piece_starts_host"),
                 f"td_piece_starts{entry}_seg_host")
    vp, i = ctypes.c_void_p, ctypes.c_int
    B, N = x.shape
    extra = {"_cp": [char_class_words("kimi").ctypes.data], "_words": [],
             "": [BP.class_lut("kimi").ctypes.data]}[entry]
    fn.argtypes = [vp, vp, i, i, i] + [vp] * len(extra) + [i, vp]
    fn.restype = i
    out = np.zeros((B, N // 32), np.uint32)
    x = np.ascontiguousarray(x)
    passes = fn(x.ctypes.data, m.ctypes.data, B, N, BP._PROFILE_ID["kimi"],
                *extra, S, out.ctypes.data)
    assert passes > 0, "kernel scratch planes exhausted"
    return out.view(np.int32)


def _k1_texts(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(EDGES) * 3,
            han_text(rng, 4000, ext_i=True),
            _bench_han_text(seed, 4090),
            "中" * 1500 + "〇" * 700 + "⺀" * 900 + "1" * 500,
            han_text(rng, 1000) + " " * 70 + "中" * 33,
            ""]


@pytest.mark.parametrize("seed", [1, 2])
def test_k1_plain_and_host_build_equal_the_split(seed):
    """K1's plain version and the host build of its derivation, whole and
    as 7 segments (runs across their edges; lengths not a multiple of 32),
    on the codepoint and class-word entries, equal Kimi K2's split."""
    texts = _k1_texts(seed)
    cp, m = _window(texts, 4096)
    plain = BP.piece_starts_chars_plain(torch.from_numpy(cp),
                                        torch.from_numpy(m), profile="kimi")
    flags = BP.unpack_mask(plain).numpy()
    for b, t in enumerate(texts):
        want = _want_starts(t)
        assert np.array_equal(flags[b, : len(t)], want), b
        assert not flags[b, len(t):].any()
        assert np.array_equal(scanner_ref.piece_starts(_cps(t),
                                                       profile="kimi"), want)
    words = char_class_words("kimi")[cp].astype(np.int32)
    assert torch.equal(BP.piece_starts_words_plain(
        torch.from_numpy(words), torch.from_numpy(m), profile="kimi"), plain)
    for S in (1, 7):
        assert np.array_equal(_host_k1("_cp", cp, m, S), plain.numpy())
        assert np.array_equal(_host_k1("_words", words, m, S),
                              plain.numpy())


@pytest.mark.parametrize("text", EDGES, ids=range(len(EDGES)))
def test_k1_edges_equal_the_split(text):
    cp, m = _window([text], 1024)
    got = BP.piece_starts_chars(torch.from_numpy(cp[0]), int(m[0]),
                                profile="kimi").numpy()
    assert np.array_equal(got[: len(text)], _want_starts(text))
    assert np.array_equal(_host_k1("_cp", cp, m, 1),
                          BP.pack_mask(torch.from_numpy(got)[None]).numpy())


def test_k1_ascii_windows():
    """ASCII windows under kimi (K1's byte entry, no Han): llama4's rules
    with the punctuation tail [\\r\\n]*."""
    rng = np.random.default_rng(4)
    from torch_port_util import ascii_text

    texts = [ascii_text(rng, 3000) + "!\n/a;\n//x", "a!\n/x\"\n//"]
    by = np.zeros((2, 4096), np.uint8)
    nb = np.zeros(2, np.int32)
    for b, t in enumerate(texts):
        by[b, : len(t)] = np.frombuffer(t.encode(), np.uint8)
        nb[b] = len(t)
    got = BP.piece_starts_bits(torch.from_numpy(by), torch.from_numpy(nb),
                               profile="kimi", packed_out=False).numpy()
    for b, t in enumerate(texts):
        assert np.array_equal(got[b, : len(t)], _want_starts(t))
    assert np.array_equal(_host_k1("", by, nb, 3), BP.pack_mask(
        torch.from_numpy(got)).numpy())


# ---------------------------------------------------------------------------
# Tokenizer through every route
# ---------------------------------------------------------------------------

SPECIALS = {"[BOS]": 30000, "[EOS]": 30001, "<|im_end|>": 30002,
            **{f"<|reserved_token_{i}|>": i for i in range(30003, 30012)}}


@pytest.fixture(scope="module")
def vocab():
    from tdbench.standin import standin_ranks

    config = {"pat_str": KIMI, "n_mergeable_ranks": 30000,
              "assumed": {"sample_bytes": {"prose": 1 << 15,
                                           "code": 1 << 13,
                                           "zh": 1 << 14}}}
    return standin_ranks(config, 2**31 + 7), SPECIALS


@pytest.fixture(scope="module")
def text():
    rng = np.random.default_rng(9)
    return ("".join(EDGES) + "[EOS]" + han_text(rng, 6000, ext_i=True)
            + "<|im_end|>" + _bench_han_text(9, 4000) + "[BOS]"
            + "中" * 1500 + "<|reserved_token_30005|>" + "⺀〇" * 200)


def _want(vocab, text):
    tiktoken = _tiktoken()
    ranks, specials = vocab
    enc = tiktoken.Encoding("kimi", pat_str=KIMI, mergeable_ranks=ranks,
                            special_tokens=specials)
    return enc.encode(text, allowed_special="all")


def test_device_path_equals_the_reference(vocab):
    """The benchmark's reference (Unicode 15.0, so no Extension I) gives
    the device path's and tiktoken's ids."""
    from tdbench.reference.encode import Reference

    rng = np.random.default_rng(8)
    text = ("".join(EDGES).replace("\U0002ebf0", "") + "[BOS]"
            + han_text(rng, 3000) + "<|im_end|>" + _bench_han_text(8, 2000))
    tok = tt.Tokenizer("kimi", pat_str=KIMI, mergeable_ranks=vocab[0],
                       special_tokens=vocab[1], device="cpu")
    want = Reference(KIMI, *vocab).encode(text)
    assert want == _want(vocab, text)
    assert tok.encode(text, allowed_special="all") == want


def test_device_path_equals_tiktoken(vocab, text):
    """4 KB windows cut at safe offsets (Han runs longer than a window grow
    it), no regex, Han misses spliced by both routes alike."""
    tok = tt.Tokenizer("kimi", pat_str=KIMI, mergeable_ranks=vocab[0],
                       special_tokens=vocab[1], device="cpu")
    eng = tok._get_device()
    assert eng.stream and eng.host._re is None
    eng._window = 1 << 12
    want = _want(vocab, text)
    assert tok.encode(text, allowed_special="all") == want
    s = eng.stats
    assert s.cut_windows >= 4 and s.grown_windows >= 1
    assert s.host_advance_windows == 0
    assert 0 < s.spliced_han < s.spliced_pieces
    if native.get_lib() is not None:
        assert s.spliced_native == s.spliced_pieces
    eng.stats, eng._splicer.native = EngineStats(), None
    assert tok.encode(text, allowed_special="all") == want
    assert (eng.stats.spliced_han, eng.stats.spliced_pieces) == (
        s.spliced_han, s.spliced_pieces)
    assert eng.stats.spliced_native == 0


def test_sub_documents_share_batched_windows(vocab):
    """A document of five sub-documents between [EOS] tokens runs its
    windows as one batch, and its ids equal tiktoken's."""
    tok = tt.Tokenizer("kimi", pat_str=KIMI, mergeable_ranks=vocab[0],
                       special_tokens=vocab[1], device="cpu")
    doc = "[EOS]".join(_bench_han_text(s, 3000 + 2000 * s)
                       for s in range(5))
    assert tok.encode(doc, allowed_special="all") == _want(vocab, doc)
    st = tok._get_device().stats
    assert (st.windows, st.window_batches) == (5, 1)
    assert 0 < st.spliced_han < st.spliced_pieces


def test_grids_equal_tiktoken(vocab, text):
    tok = tt.Tokenizer("kimi", pat_str=KIMI, mergeable_ranks=vocab[0],
                       special_tokens=vocab[1], device="cpu")
    rng = np.random.default_rng(5)
    cuts = sorted(rng.integers(0, len(text), 24).tolist())
    short = [text[a:a + int(rng.integers(1, 1300))] for a in cuts]
    got = tok.encode_batch(short, allowed_special="all")
    assert got == [_want(vocab, t) for t in short]
    assert tok._get_device().stats.grid_rows >= 20


@pytest.mark.parametrize("binding", ["native", "python"])
def test_host_backend_equals_tiktoken(vocab, text, binding, monkeypatch):
    if binding == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(native, "get_pymod", lambda: None)
    elif native.get_lib() is None:
        pytest.skip("no C++ toolchain for tdnative.cpp")
    tok = tt.Tokenizer("kimi", pat_str=KIMI, mergeable_ranks=vocab[0],
                       special_tokens=vocab[1], backend="host")
    assert (tok.host_binding == "python") == (binding == "python")
    if binding == "python":  # the pure-Python merge: a part of the text
        text = text[:2500] + text[-2500:]
    assert tok.encode(text, allowed_special="all") == _want(vocab, text)
    parts = [text[:2000], text[2000:]]
    assert tok.encode_batch(parts, allowed_special="all") == [
        _want(vocab, t) for t in parts]


def test_streaming_equals_encode(vocab, text):
    tok = tt.Tokenizer("kimi", pat_str=KIMI, mergeable_ranks=vocab[0],
                       special_tokens=vocab[1], backend="host")
    enc = tt.StreamingEncoder(tok, allowed_special="all")
    rng = np.random.default_rng(6)
    out, at = [], 0
    while at < len(text):
        k = int(rng.integers(1, 3000))
        out += enc.feed(text[at:at + k])
        at += k
    out += enc.flush()
    assert out == _want(vocab, text)


def test_safe_cut_never_falls_inside_a_han_run(vocab):
    """The window's last class run is its Han run, whatever classes its
    chars have (letters, radicals, numerals)."""
    eng = DeviceEngine(KIMI, *vocab, device="cpu")
    run = "中⺀〇々" * 3000
    window = ("abc! 12 " + run).encode()
    assert eng._safe_cut_threshold(window) <= len(b"abc! 12 ")
    co = coarse_classes(_cps("a1 !中⺀〇"), han=True)
    assert co.tolist() == [2, 1, 0, 3, 4, 4, 4]
    assert coarse_classes(_cps("中⺀〇")).tolist() == [2, 3, 1]


# ---------------------------------------------------------------------------
# entry points that refuse the profile, and F8
# ---------------------------------------------------------------------------


def test_entry_points_without_han_refuse_kimi(vocab):
    from tokendagger_tpu_torch.parallel.resident_mesh import (
        mesh_resident_pipeline,
    )
    from tokendagger_tpu_torch.parallel.sharded_text import (
        ShardedTextEncoder,
    )
    from tokendagger_tpu_torch.unicode_tables import get_two_level_tables

    ranks, specials = vocab
    with pytest.raises(NotImplementedError, match="ResidentStream"):
        tt.ResidentStream(ranks, specials, KIMI, device="cpu")
    with pytest.raises(NotImplementedError, match="ResidentStream"):
        tt.ResidentStream(ranks, specials, tt.LLAMA4_PATTERN,
                          profile="kimi", device="cpu")
    with pytest.raises(NotImplementedError, match="run_resident"):
        tt.run_resident(ranks, specials, KIMI, b"abc", device="cpu")
    eng = DeviceEngine(KIMI, ranks, specials, device="cpu")
    with pytest.raises(NotImplementedError, match="ShardedTextEncoder"):
        ShardedTextEncoder(eng, None)
    with pytest.raises(NotImplementedError, match="mesh_resident_pipeline"):
        mesh_resident_pipeline(None, None, None, None, window=1024,
                               p_cap=1024, profile="kimi")
    page_ids, pages = (torch.from_numpy(a.astype(np.int64))
                       for a in get_two_level_tables())
    cp = torch.zeros(64, dtype=torch.int32)
    cp[:40] = torch.from_numpy(_cps("中文 abc 12〇 ⺀!" * 4)[:40])
    for fn in (PT.match_lengths, PT.piece_starts):
        with pytest.raises(NotImplementedError):
            fn(cp, 40, page_ids, pages, profile="kimi")
    # compute_starts serves kimi through K1
    assert torch.equal(
        PT.compute_starts(cp, 40, page_ids, pages, profile="kimi"),
        BP.piece_starts_chars(cp, 40, profile="kimi"))


def test_regex_fallback_reads_class_intersection():
    """F8: a pattern outside the profiles compiles with ``regex`` V1, which
    reads ``[A&&[^B]]`` as tiktoken does (V0 dropped every Latin word)."""
    tiktoken = _tiktoken()
    pat = KIMI.replace("(?i:'s|'t|'re|'ve|'m|'ll|'d)?", "")
    assert tt.classify_pattern(pat) is None
    ranks = {bytes([b]): b for b in range(256)}
    for p in ("Hello", " world", "你好世界"):
        ranks[p.encode()] = len(ranks)
    host = HostEngine(pat, ranks, {})
    text = "Hello world, 你好世界！"
    assert host.split(text) == ["Hello", " world", ",", " ", "你好世界", "！"]
    enc = tiktoken.Encoding("k", pat_str=pat, mergeable_ranks=ranks,
                            special_tokens={})
    more = text + _bench_han_text(3, 3000)
    assert host.encode_ordinary(more) == enc.encode_ordinary(more)
