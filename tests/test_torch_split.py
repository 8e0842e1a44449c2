"""The stream path's split at specials in byte space, held against the JAX
package: ``DeviceEngine(device="cpu")``'s ``encode_batch`` ids against the
JAX ``HostEngine`` (under kimi, whose split the JAX engine's ``regex`` V0
reads otherwise, its ``split_specials`` with tiktoken's ordinary encode of
each segment) under the four profiles (specials at the edges, adjacent,
alone, unclosed, beside 2-, 3- and 4-byte characters and Han) with the
full allowed set, a strict subset and none; the byte offsets and segments
of the split against the JAX ``find_all_specials`` / ``split_specials``;
the native scan (``td_find_specials_l``) and the host route's
``encode_with_specials`` against the JAX native engine's, with special sets
of one to five first bytes (Kimi K2's ``<`` and ``[`` among them); that
only ``backend="auto"`` reads ``Tokenizer._nbytes``; a lone surrogate's
error; an unknown allowed token's ``KeyError``; the counters
``split_bytes`` and ``split_native``."""

import numpy as np
import pytest

import tokendagger_tpu_torch as tt
from conftest import make_tiny_vocab
from tokendagger_tpu import native as JN
from tokendagger_tpu.hostengine import HostEngine as RefHost
from tokendagger_tpu.tables import build_tables as jax_build_tables
from tokendagger_tpu_torch import CL100K_PATTERN, GPT2_PATTERN, KIMI_PATTERN
from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine
from tokendagger_tpu_torch import native as TN
from tokendagger_tpu_torch import tables as TT
from tokendagger_tpu_torch.wrapper import TokenDaggerError

PATTERNS = {"llama4": LLAMA4_PATTERN, "cl100k": CL100K_PATTERN,
            "gpt2": GPT2_PATTERN, "kimi": KIMI_PATTERN}

# make_tiny_vocab's five, specials of 2-, 3- and 4-byte characters, one
# that holds "<|eos|>" as a byte prefix (a same-position tie) and a
# bracketed one
EXTRA = {"<|é|>": 5005, "<|日本|>": 5006, "<|eos|>🙂": 5007, "[EOS]": 5008,
         "🙂🙂": 5009}
SUBSET = frozenset({"<|eos|>", "<|日本|>", "🙂🙂"})

# Kimi K2's kind of set: "<|...|>" and "[...]" specials
KIMI_LIKE = {"[BOS]": 6000, "[EOS]": 6001, "<|im_end|>": 6002,
             "<|im_user|>": 6003, "<|im_assistant|>": 6004, "[EOT]": 6005,
             "<|start_header_id|>": 6006, "<|end_header_id|>": 6007,
             "<|im_system|>": 6008, "<|im_middle|>": 6009, "[UNK]": 6010}

TEXTS = [
    "<|bos|>hello world",                   # at the start
    "hello world<|eos|>",                   # at the end
    "a<|eos|><|bos|><|pad|>b",              # adjacent
    "<|eos|><|bos|><|日本|><|eos|>🙂",       # only specials
    "hello there, the world is 12345\n",    # none
    "",
    "text <|endof and <|eos and <|日 and [EO",   # unclosed prefixes
    "é<|eos|>é€<|bos|>€🙂<|pad|>🙂",          # 2-, 3-, 4-byte neighbours
    "中文<|eos|>中文日本<|日本|>本日",           # Han on both sides
    "x🙂🙂🙂y<|é|>é<|é|",                     # overlapping candidates
    "<|eos|>🙂🙂 [EOS][EOS] <|fim_prefix|>def f(x):<|fim_suffix|>",
    "<|<|eos|>|> <<||eos|>",
]


def _specials():
    ranks, specials = make_tiny_vocab()
    return ranks, {**specials, **EXTRA}


class _Reference:
    """The JAX package's host engine for one profile: the split at
    specials, and the ids. Under kimi the ordinary segments take tiktoken
    (the JAX engine compiles the pattern with ``regex`` V0, which reads
    kimi's class intersection otherwise)."""

    def __init__(self, profile, ranks, specials):
        self.host = RefHost(PATTERNS[profile], ranks, specials)
        self.tik = None
        if profile == "kimi":
            tiktoken = pytest.importorskip("tiktoken")
            self.tik = tiktoken.Encoding("kimi", pat_str=KIMI_PATTERN,
                                         mergeable_ranks=ranks,
                                         special_tokens=specials)

    def ids(self, text, allowed):
        if self.tik is None:
            return self.host.encode(text, allowed)[0]
        out = []
        for seg, sid in self.host.split_specials(text, allowed):
            out.extend([sid] if sid is not None
                       else self.tik.encode_ordinary(seg))
        return out

    def matches(self, text, allowed):
        """(byte offset, id, byte length) of each special it finds."""
        return [(len(text[:p].encode()), self.host.special_tokens[t],
                 len(t.encode())) for p, t in
                self.host.find_all_specials(text, allowed)]

    def splits(self, text, allowed):
        return [(seg.encode(), sid)
                for seg, sid in self.host.split_specials(text, allowed)]


@pytest.fixture(scope="module")
def engines():
    ranks, specials = _specials()
    return {name: (DeviceEngine(pat, ranks, specials, device="cpu"),
                   _Reference(name, ranks, specials))
            for name, pat in PATTERNS.items()}


def _jax_scan(specials):
    """The JAX package's native engine with ``specials`` installed (its
    ``td_find_specials`` skips only to one shared first byte)."""
    if JN.get_lib() is None:
        pytest.skip("no C++ toolchain")
    ranks, _ = make_tiny_vocab()
    jt = jax_build_tables(ranks, specials)
    ref = JN.NativeEngine(jt.pair.rows, jt.pair.mask, jt.byte_rank,
                          profile="llama4", ranks=ranks)
    assert ref.set_specials(specials)
    return ref


def _long_text() -> str:
    """~80 KB (over one 64 KB CPU window) with specials every few KB."""
    rng = np.random.default_rng(2**35 + 11)
    parts = ["hello", " the", " 日本語", " café", "🙂", "\n", " 123",
             "<|eos|>", "<|日本|>", "  ", "中文", "<|eos|>🙂"]
    weights = np.asarray([30, 30, 8, 8, 4, 6, 6, 1, 1, 6, 4, 1], float)
    idx = rng.choice(len(parts), size=16000, p=weights / weights.sum())
    return "".join(parts[int(i)] for i in idx)


def _allowed(kind: str, specials) -> frozenset:
    return {"full": frozenset(specials), "subset": SUBSET,
            "none": frozenset()}[kind]


def _splits(eng, datas, allowed):
    return [list(parts) for parts in eng._split_bytes(datas, allowed)]


@pytest.mark.parametrize("allowed", ["full", "subset", "none"])
@pytest.mark.parametrize("profile", list(PATTERNS))
def test_encode_batch_equals_host(engines, profile, allowed):
    eng, ref = engines[profile]
    allow = _allowed(allowed, ref.host.special_tokens)
    texts = TEXTS + ([_long_text()] if profile == "llama4" else [])
    got = eng.encode_batch(texts, allow)
    assert got == [ref.ids(t, allow) for t in texts]
    # one text a call, as Tokenizer.encode sends them
    assert [eng.encode_batch([t], allow)[0] for t in TEXTS] == got[:len(
        TEXTS)]


@pytest.mark.parametrize("allowed", ["full", "subset", "none"])
@pytest.mark.parametrize("profile", list(PATTERNS))
def test_byte_split_equals_the_reference(engines, monkeypatch, profile,
                                         allowed):
    """The Python byte scan's offsets, and the split by the native scan
    (the full set) and by the Python one, against the JAX engine's."""
    eng, ref = engines[profile]
    allow = _allowed(allowed, ref.host.special_tokens)
    texts = TEXTS + _fuzz_texts(100)
    datas = [t.encode() for t in texts]
    want = [ref.splits(t, allow) for t in texts]
    assert _splits(eng, datas, allow) == want
    monkeypatch.setattr(eng, "_sp_scan", None)
    assert _splits(eng, datas, allow) == want
    if allow:
        for t, d in zip(texts, datas):
            assert eng.host.find_all_specials_bytes(d, allow) == (
                ref.matches(t, allow))


@pytest.mark.parametrize("allowed", ["full", "subset", "none"])
def test_segments_equal_the_str_split(engines, monkeypatch, allowed):
    eng, ref = engines["llama4"]
    allow = _allowed(allowed, ref.host.special_tokens)
    texts = TEXTS + [_long_text()]
    seen = []
    real = eng.encode_streams

    def spy(segments):
        seen.append(list(segments))
        return real(segments)

    monkeypatch.setattr(eng, "encode_streams", spy)
    eng.encode_batch(texts, allow)
    want = [seg for t in texts for seg, sid in ref.splits(t, allow)
            if sid is None]
    assert len(seen) == 1
    assert seen[0] == want
    assert all(type(s) is bytes and s for s in seen[0])


def _fuzz_texts(n: int) -> list[str]:
    rng = np.random.default_rng(2**40 + 3)
    alphabet = ["<|", "|>", "<", "|", "eos", "bos", "<|eos|>", "<|bos|>",
                "<|日本|>", "<|é|>", "<|eos|>🙂", "🙂", "🙂🙂", "[EOS]", "[",
                "EOS]", "日", "本", "é", "€", "a", " ", "\n", "中文"]
    return ["".join(alphabet[int(i)] for i in
                    rng.integers(len(alphabet), size=int(rng.integers(0, 40))))
            for _ in range(n)]


def test_native_scan_equals_python_scan(engines, monkeypatch):
    """The native scan on the splicer's handle (first bytes "<", "[" and
    the lead byte of 🙂) against the JAX native scan and the JAX engine's
    split, and the split it gives against the Python scan's."""
    eng, ref = engines["kimi"]
    if eng._sp_scan is None:
        pytest.skip("no native library (g++ missing)")
    _, specials = _specials()
    jax = _jax_scan(specials)
    full = eng.host.all_specials
    dense = "<|eos|>" * 1500 + "🙂🙂x" * 1000   # past the first capacity
    texts = TEXTS + _fuzz_texts(400) + [_long_text(), dense]
    for text in texts:
        data = text.encode("utf-8")
        pos, ids, lens = eng._sp_scan.find_specials_l(data)
        jpos, jids = jax.find_specials(data)
        assert pos.tolist() == jpos.tolist() and ids.tolist() == jids.tolist()
        assert list(zip(pos.tolist(), ids.tolist(), lens.tolist())) == (
            ref.matches(text, full))
    datas = [t.encode("utf-8") for t in texts]
    want = [ref.splits(t, full) for t in texts]
    assert _splits(eng, datas, full) == want
    monkeypatch.setattr(eng, "_sp_scan", None)
    assert _splits(eng, datas, full) == want


def _first_byte_texts(specials, n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    parts = list(specials) + ["<", "[", "{", "@", "a", "é", "日", "🙂",
                              "\x1e\x1e", "x", "<|im", "[EO", "|>", "]"]
    return ["".join(parts[int(i)] for i in
                    rng.integers(len(parts), size=int(rng.integers(0, 30))))
            for _ in range(n)]


@pytest.mark.parametrize("extra", [
    {"\x1e": 6000, "§": 6001},                  # 1-byte, 3 first bytes
    {"<x": 6000, "[a]": 6001, "{{": 6002, "@@": 6003, "\x1e": 6004},
    KIMI_LIKE,                                  # "<" and "[" alone
])
def test_native_scan_by_first_bytes(extra):
    """The native scan where it skips to the nearest of a few first bytes
    (a 1-byte special among them; Kimi K2's two) and where it walks every
    byte (more than four first bytes), against the JAX native scan, the
    JAX engine's split and find_all_specials_bytes."""
    ranks, specials = make_tiny_vocab()
    specials = {**specials, **extra}
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu")
    if eng._sp_scan is None:
        pytest.skip("no native library (g++ missing)")
    jax = _jax_scan(specials)
    ref = _Reference("llama4", ranks, specials)
    full = eng.host.all_specials
    for text in _first_byte_texts(specials, 300, 2**41 + 7):
        data = text.encode("utf-8")
        pos, ids, lens = eng._sp_scan.find_specials_l(data)
        jpos, jids = jax.find_specials(data)
        assert pos.tolist() == jpos.tolist() and ids.tolist() == jids.tolist()
        want = ref.matches(text, full)
        assert list(zip(pos.tolist(), ids.tolist(), lens.tolist())) == want
        assert eng.host.find_all_specials_bytes(data, full) == want


@pytest.mark.parametrize("extra", [
    {"\x1e": 6000, "§": 6001},
    {"<x": 6000, "[a]": 6001, "{{": 6002, "@@": 6003, "\x1e": 6004},
    KIMI_LIKE,
])
def test_host_route_specials_by_first_bytes(extra):
    """The host route's native engine (``td_find_specials_l`` under ctypes
    and inside the extension's ``encode_with_specials``) against the JAX
    native engine and the JAX host engine's ids, on the same bytes."""
    ranks, specials = make_tiny_vocab()
    specials = {**specials, **extra}
    if TN.get_lib() is None:
        pytest.skip("no C++ toolchain")
    jax = _jax_scan(specials)
    pair = TT.build_pair_table(ranks)
    port = TN.NativeEngine(pair.rows, pair.mask, TT.byte_rank(ranks),
                           profile="llama4", ranks=ranks)
    assert port.set_specials(specials)
    ref = RefHost(LLAMA4_PATTERN, ranks, specials)
    for text in _first_byte_texts(specials, 150, 2**42 + 9):
        data = text.encode("utf-8")
        pos, ids, _ = port.find_specials_l(data)
        jpos, jids = jax.find_specials(data)
        assert pos.tolist() == jpos.tolist() and ids.tolist() == jids.tolist()
        want = ref.encode(text, set(specials))[0]
        got = port.encode_with_specials(data, num_threads=1)
        if got is not None:     # None without the CPython extension
            assert got == want == jax.encode_with_specials(data, 1)


@pytest.mark.parametrize("allowed", ["subset", "none"])
def test_python_byte_scan_equals_str_scan(engines, allowed):
    eng, ref = engines["llama4"]
    allow = _allowed(allowed, ref.host.special_tokens)
    for text in TEXTS + _fuzz_texts(400):
        assert eng.host.find_all_specials_bytes(text.encode("utf-8"),
                                                allow) == (
            ref.matches(text, allow))


def test_declined_special_set_takes_the_python_scan():
    ranks, specials = _specials()
    long = "<|" + "x" * 300 + "|>"          # over 255 bytes: declined
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, {**specials, long: 6000},
                       device="cpu")
    ref = RefHost(LLAMA4_PATTERN, ranks, {**specials, long: 6000})
    assert eng._sp_scan is None
    texts = [t + long for t in TEXTS]
    allow = eng.host.all_specials
    assert eng.encode_batch(texts, allow) == [ref.encode(t, allow)[0]
                                              for t in texts]
    n = sum(len(t.encode("utf-8")) for t in texts)
    assert (eng.stats.split_bytes, eng.stats.split_native) == (n, 0)


def _tokenizer(backend: str):
    ranks, specials = _specials()
    return tt.Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                        special_tokens=specials, backend=backend,
                        device="cpu")


def _ref_host() -> RefHost:
    return RefHost(LLAMA4_PATTERN, *_specials())


def _calls(tok, text, allowed="all"):
    return [
        lambda: tok.encode(text, allowed_special=allowed),
        lambda: tok.encode_ordinary(text),
        lambda: tok.encode_batch([text, text], allowed_special=allowed),
        lambda: tok.encode_batch_np([text], allowed_special=allowed),
        lambda: tok.encode_ordinary_batch([text]),
    ]


@pytest.mark.parametrize("backend", ["device", "host"])
def test_nbytes_not_read_under_a_fixed_backend(monkeypatch, backend):
    def refuse(texts):
        raise AssertionError("_nbytes read")

    tok = _tokenizer(backend)
    monkeypatch.setattr(tok, "_nbytes", refuse)
    ref = _ref_host()
    text = TEXTS[8]
    want = [ref.encode(text, ref.all_specials)[0], ref.encode_ordinary(text)]
    got = [f() for f in _calls(tok, text)]
    assert got[:2] == want
    assert got[2] == [want[0], want[0]]
    assert got[3][0].tolist() == want[0]
    assert got[4] == [want[1]]


def test_nbytes_read_under_auto(monkeypatch):
    tok = _tokenizer("auto")
    real = tok._nbytes
    read = []

    def count(texts):
        read.append(list(texts))
        return real(texts)

    monkeypatch.setattr(tok, "_nbytes", count)
    text = TEXTS[8]
    for f in _calls(tok, text):
        f()
    assert read == [[text], [text], [text, text], [text], [text]]


class _CountingStr(str):
    """A str that counts its encode calls (slices are plain str)."""

    def encode(self, *args, **kwargs):
        self.encodes += 1
        return super().encode(*args, **kwargs)


def test_device_route_encodes_each_text_once():
    tok = _tokenizer("device")
    ref = _ref_host()
    for t in TEXTS[1:]:
        text = _CountingStr(t)
        text.encodes = 0
        want = ref.encode(t, ref.all_specials)[0]
        assert tok.encode(text, allowed_special="all") == want
        assert text.encodes == 1
        assert tok.encode_batch([text], allowed_special="all")[0] == want
        assert text.encodes == 2


@pytest.mark.parametrize("backend", ["device", "host"])
def test_lone_surrogate_raises_as_before(backend):
    """As at the parent of the byte-space split: encode_ordinary wraps the
    UnicodeEncodeError, the other calls raise it, under the full allowed
    set and under one with a name that is not a special (the Tokenizer
    drops it)."""
    tok = _tokenizer(backend)
    text = "abc \ud800 x<|eos|>y"
    for allowed in ("all", {"<|eos|>", "<|nope|>"}):
        for i, f in enumerate(_calls(tok, text, allowed)):
            with pytest.raises((UnicodeEncodeError, TokenDaggerError)) as info:
                f()
            if i == 1:          # encode_ordinary wraps the error
                assert info.type is TokenDaggerError
                assert isinstance(info.value.__cause__, UnicodeEncodeError)
            else:
                assert info.type is UnicodeEncodeError
    eng = DeviceEngine(LLAMA4_PATTERN, *_specials(), device="cpu")
    for allow in (eng.host.all_specials, SUBSET, frozenset()):
        with pytest.raises(UnicodeEncodeError):
            eng.encode_batch(["ok", text], allow)
    with pytest.raises(UnicodeEncodeError):
        eng.encode_ordinary_batch([text])


@pytest.mark.parametrize("stream", [True, False])
def test_unknown_allowed_token_raises_key_error(stream):
    """Before the text's encode too (a lone surrogate), on both paths."""
    eng = DeviceEngine(LLAMA4_PATTERN, *_specials(), device="cpu",
                       stream=stream)
    for allow in ({"<|nope|>"}, {"<|eos|>", "<|nope|>"}):
        for text in ("a<|eos|>b", "a\ud800<|eos|>b"):
            with pytest.raises(KeyError, match="nope"):
                eng.encode_batch([text], allow)
    assert eng.encode_batch([], {"<|nope|>"}) == []


def test_split_counters():
    eng = DeviceEngine(LLAMA4_PATTERN, *_specials(), device="cpu")
    texts = TEXTS + ["日本語 " * 50]
    n = sum(len(t.encode("utf-8")) for t in texts)
    native = n if eng._sp_scan is not None else 0
    eng.encode_batch(texts, eng.host.all_specials)
    assert (eng.stats.split_bytes, eng.stats.split_native) == (n, native)
    eng.encode_batch(texts, SUBSET)          # scanned in Python
    assert (eng.stats.split_bytes, eng.stats.split_native) == (2 * n, native)
    eng.encode_batch(texts, frozenset())     # nothing to split at
    eng.encode_ordinary_batch(texts)
    assert (eng.stats.split_bytes, eng.stats.split_native) == (2 * n, native)
    piece = DeviceEngine(LLAMA4_PATTERN, *_specials(), device="cpu",
                         stream=False)
    piece.encode_batch(texts[:3], piece.host.all_specials)
    assert (piece.stats.split_bytes, piece.stats.split_native) == (0, 0)
