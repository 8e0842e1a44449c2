"""The rest of the port's public API on the CPU, held against the JAX
package's and an offline tiktoken.Encoding, with exact equality: the
registry, load_tekken, the command line, StreamingEncoder,
CorpusProcessor and encode_with_unstable."""

import base64
import json

import numpy as np
import pytest
import tiktoken

import tokendagger_tpu as jtd
import tokendagger_tpu_torch as tt
from tests.conftest import make_tiny_vocab
from tokendagger_tpu import cli as jax_cli
from tokendagger_tpu.corpus import CorpusProcessor as JaxCorpusProcessor
from tokendagger_tpu.streaming import StreamingEncoder as JaxStreamingEncoder
from tokendagger_tpu_torch import cli, registry
from tokendagger_tpu_torch.corpus import CorpusProcessor
from tokendagger_tpu_torch.vocab import (
    TEKKEN_PATTERN, ranks_to_vocab_list, vocab_list_to_ranks,
)
from torch_port_util import multiscript_text


@pytest.fixture(scope="module")
def vocab():
    return make_tiny_vocab()


def _tok(vocab, **kw):
    ranks, specials = vocab
    kw.setdefault("device", "cpu")
    return tt.Tokenizer("t", pat_str=tt.LLAMA4_PATTERN, mergeable_ranks=ranks,
                        special_tokens=specials, **kw)


@pytest.fixture
def model_files(tmp_path, vocab):
    ranks, specials = vocab
    model = tmp_path / "tok.model"
    model.write_bytes(b"\n".join(base64.b64encode(k) + b" " + str(v).encode()
                                 for k, v in ranks.items()))
    config = tmp_path / "cfg.json"
    config.write_text(json.dumps({"added_tokens_decoder": {
        str(v): {"content": k} for k, v in specials.items()}}))
    return model, config


def _write_tekken(path, vocab, pattern=TEKKEN_PATTERN):
    """A tekken.json of the tiny vocabulary: ordinary entry i holds the
    token of rank i, and the specials take the first ids."""
    ranks, specials = vocab
    by_rank = sorted(ranks, key=ranks.get)
    n_sp = len(specials)
    path.write_text(json.dumps({
        "config": {"pattern": pattern, "default_num_special_tokens": n_sp,
                   "default_vocab_size": n_sp + len(by_rank) - 3},
        "vocab": [{"rank": i, "token_bytes": base64.b64encode(t).decode(),
                   "token_str": None} for i, t in enumerate(by_rank)],
        "special_tokens": [{"rank": i, "token_str": s, "is_control": True}
                           for i, s in enumerate(sorted(specials))],
    }))
    return path


def test_exports_equal_reference():
    for name in ("get_encoding", "register_encoding", "list_encodings",
                 "StreamingEncoder", "load_tekken", "__version__"):
        assert hasattr(tt, name), name
        assert name in tt.__all__
    assert tt.__version__ == jtd.__version__
    assert set(jtd.__all__) <= set(tt.__all__)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_register_and_get(model_files, vocab, monkeypatch):
    """File paths build a device-backend Tokenizer on the default device
    (made the CPU here); registering again drops the cached one."""
    import functools

    model, config = model_files
    monkeypatch.setattr(registry, "Tokenizer",
                        functools.partial(tt.Tokenizer, device="cpu"))
    tt.register_encoding("port-unit-enc", vocab_file=model,
                         config_file=config)
    enc = tt.get_encoding("port-unit-enc")
    assert enc.device.type == "cpu" and enc.backend == "device"
    text = "hello <|bos|> world don't"
    want = _tok(vocab, backend="host").encode(text, allowed_special="all")
    assert enc.encode(text, allowed_special="all") == want
    assert tt.get_encoding("port-unit-enc") is enc      # cached
    assert "port-unit-enc" in tt.list_encodings()
    # registering again drops the cached tokenizer
    tt.register_encoding("port-unit-enc",
                         loader=lambda: _tok(vocab, backend="host"))
    again = tt.get_encoding("port-unit-enc")
    assert again is not enc and again.backend == "host"


def test_custom_loader(vocab):
    tt.register_encoding("port-loader-enc", loader=lambda: _tok(vocab))
    assert tt.get_encoding("port-loader-enc").encode_ordinary("the x") == (
        _tok(vocab, backend="host").encode_ordinary("the x"))


def test_register_needs_a_source():
    with pytest.raises(ValueError, match="loader="):
        tt.register_encoding("nothing")


def test_env_builtins(model_files, tmp_path, vocab, monkeypatch):
    """"llama4" and "tekken" resolve from their env vars, on the default
    device (made the CPU here)."""
    import functools

    model, config = model_files
    tekken = _write_tekken(tmp_path / "tekken.json", vocab)
    monkeypatch.setattr(registry, "Tokenizer",
                        functools.partial(tt.Tokenizer, device="cpu"))
    monkeypatch.setenv("TOKENDAGGER_LLAMA4_MODEL", str(model))
    monkeypatch.setenv("TOKENDAGGER_LLAMA4_CONFIG", str(config))
    monkeypatch.setenv("TOKENDAGGER_TEKKEN_JSON", str(tekken))
    for name in ("llama4", "tekken"):
        registry._CACHE.pop(name, None)
    try:
        assert {"llama4", "tekken"} <= set(tt.list_encodings())
        llama = tt.get_encoding("llama4")
        assert llama.pattern == tt.LLAMA4_PATTERN
        assert llama.encode("<|bos|>the", allowed_special="all") == (
            _tok(vocab).encode("<|bos|>the", allowed_special="all"))
        tek = tt.get_encoding("tekken")
        assert tek.pattern == TEKKEN_PATTERN
        assert tek.encode_ordinary("the cat") == (
            jtd.Encoding("t", pat_str=TEKKEN_PATTERN,
                         **_jax_tekken(tekken)).encode_ordinary("the cat"))
    finally:
        for name in ("llama4", "tekken"):
            registry._CACHE.pop(name, None)


def _jax_tekken(path):
    cfg = jtd.load_tekken(path)
    return dict(mergeable_ranks=cfg["mergeable_ranks"],
                special_tokens=cfg["special_tokens"])


def test_unknown_raises():
    with pytest.raises(ValueError, match="Unknown encoding"):
        tt.get_encoding("definitely-not-registered")


def test_tiktoken_names_raise_without_its_data(monkeypatch):
    """A standard tiktoken name whose data tiktoken cannot supply raises
    ValueError naming it (tiktoken's loader is replaced by one that
    fails, as it does without its cache and network)."""
    def no_data(name):
        raise OSError(f"no vocab data for {name}")

    monkeypatch.setattr(tiktoken, "get_encoding", no_data)
    for name in sorted(registry._TIKTOKEN_NAMES):
        with pytest.raises(ValueError, match=name):
            tt.get_encoding(name)


# ---------------------------------------------------------------------------
# load_tekken and the vocab-list helpers
# ---------------------------------------------------------------------------


def test_load_tekken_round_trip(tmp_path, vocab):
    path = _write_tekken(tmp_path / "tekken.json", vocab)
    got = tt.load_tekken(path)
    want = jtd.load_tekken(path)
    assert got == want
    ranks, specials = vocab
    n_sp = len(specials)
    assert got["mergeable_ranks"] == {
        t: r + n_sp for t, r in ranks.items() if r < len(ranks) - 3}
    assert got["special_tokens"] == {s: i for i, s
                                     in enumerate(sorted(specials))}
    assert tt.load_tekken(path, include_special_tokens=False)[
        "special_tokens"] == {}
    enc = tt.Encoding("tekken", pat_str=got["pattern"],
                      mergeable_ranks=got["mergeable_ranks"],
                      special_tokens=got["special_tokens"], device="cpu")
    text = multiscript_text(np.random.default_rng(1), 3000)
    tk = tiktoken.Encoding("tekken", pat_str=got["pattern"],
                           mergeable_ranks=got["mergeable_ranks"],
                           special_tokens=got["special_tokens"])
    assert enc.encode_ordinary(text) == tk.encode_ordinary(text)


def test_vocab_list_round_trip(vocab):
    from tokendagger_tpu.vocab import ranks_to_vocab_list as jax_to_list

    ranks, _ = vocab
    lst = ranks_to_vocab_list(ranks)
    assert lst == jax_to_list(ranks)
    assert vocab_list_to_ranks(lst) == ranks


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["host", "device"])
def test_cli_encode(capsys, model_files, backend):
    model, config = model_files
    text = "hello <|bos|> world don't 123"
    args = ["encode", "--model", str(model), "--config", str(config),
            "--text", text, "--allow-special"]
    assert cli.main(args + ["--backend", backend, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_cli.main(args + ["--backend", "host"]) == 0
    assert got == json.loads(capsys.readouterr().out)


def test_cli_encode_tekken(capsys, tmp_path, vocab):
    path = _write_tekken(tmp_path / "tekken.json", vocab)
    args = ["encode", "--tekken", str(path), "--text", "the cat sat"]
    assert cli.main(args + ["--backend", "device", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_cli.main(args + ["--backend", "host"]) == 0
    assert got == json.loads(capsys.readouterr().out)


def test_cli_bench(capsys, model_files):
    model, _ = model_files
    rc = cli.main(["bench", "--model", str(model), "--backend", "host",
                   "--device", "cpu", "--warmup", "1", "--iterations", "5",
                   "--text", "the quick brown fox"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["iterations"] == 5 and out["tokens"] > 0
    assert out["backend"] == "host" and out["device"] == "cpu"
    assert out["min_us"] <= out["avg_us"] <= out["max_us"]


def test_cli_requires_model():
    with pytest.raises(SystemExit):
        cli.main(["encode", "--text", "x"])
    with pytest.raises(SystemExit):
        cli.main(["encode", "--model", "m", "--backend", "tpu"])


# ---------------------------------------------------------------------------
# StreamingEncoder
# ---------------------------------------------------------------------------


def _chunks(rng, text, hi):
    out, i = [], 0
    while i < len(text):
        k = int(rng.integers(1, hi))
        out.append(text[i : i + k])
        i += k
    return out


@pytest.mark.parametrize("backend", ["device", "host"])
def test_streaming_equals_jax(vocab, backend):
    """Chunked text with a special split across chunks: the whole equals
    the JAX StreamingEncoder's and one encode, and no feed returns more
    than the JAX one has returned by then (the port holds back a final
    whitespace piece: see test_streaming_whitespace_before_punctuation)."""
    ranks, specials = vocab
    tok = _tok(vocab, backend=backend)
    jtok = jtd.Tokenizer("t", pattern=tt.LLAMA4_PATTERN,
                         mergeable_ranks=ranks, special_tokens=specials,
                         backend="host")
    rng = np.random.default_rng(3)
    sp = sorted(specials)
    text = (multiscript_text(rng, 20000) + sp[0] + "  tail  \n\n"
            + multiscript_text(rng, 5000) + sp[1] + "end " * 50 + sp[0][:-2])
    chunks = _chunks(rng, text, 700)
    # the first special split across two chunks
    at = text.index(sp[0]) + 3
    chunks = _chunks(rng, text[:at], 700) + _chunks(rng, text[at:], 700)
    enc = tt.StreamingEncoder(tok, allowed_special="all")
    jenc = JaxStreamingEncoder(jtok, allowed_special="all")
    out, jout = [], []
    for c in chunks:
        out += enc.feed(c)
        jout += jenc.feed(c)
        assert jout[: len(out)] == out
    out += enc.flush()
    jout += jenc.flush()
    assert out == jout == tok.encode(text, allowed_special="all")
    assert sum(1 for i in out if i in specials.values()) == 2


def test_streaming_whitespace_before_punctuation(vocab):
    """A whitespace run before punctuation splits before its last char
    ("\\s+(?!\\S)"), but a text that ends in the run keeps it whole. The
    JAX StreamingEncoder encodes the final pieces of a feed as one text
    that ends there, so with a token for the whole run its ids differ from
    one encode; the port's feed stops before a final whitespace piece."""
    ranks, specials = vocab
    ranks = dict(ranks)
    ranks[" \u3000\u3000".encode()] = max(ranks.values()) + 1
    text = "a first \u3000\u3000'LL the"
    tok = tt.Tokenizer("t", pat_str=tt.LLAMA4_PATTERN, mergeable_ranks=ranks,
                       special_tokens=specials, device="cpu")
    jtok = jtd.Tokenizer("t", pattern=tt.LLAMA4_PATTERN,
                         mergeable_ranks=ranks, special_tokens=specials,
                         backend="host")
    want = tok.encode(text)
    enc = tt.StreamingEncoder(tok)
    first = enc.feed(text)
    assert first + enc.flush() == want
    assert first == want[:6]                 # "a", " first" (as bytes)
    jenc = JaxStreamingEncoder(jtok)
    assert jenc.feed(text) + jenc.flush() != want


def test_streaming_holds_back_and_refuses(vocab):
    tok = _tok(vocab)
    enc = tt.StreamingEncoder(tok, allowed_special="all")
    assert enc.feed("aaaa") == []            # one class run: nothing final
    assert enc.feed("<|bo") == enc.feed("") == []
    assert enc.feed("s|>b c") + enc.flush() == tok.encode(
        "aaaa<|bos|>b c", allowed_special="all")
    with pytest.raises(KeyError):
        tt.StreamingEncoder(tok, allowed_special={"<|nope|>"})
    ranks, specials = vocab
    other = tt.Tokenizer("o", pat_str=r"\w+|\s+", mergeable_ranks=ranks,
                         backend="host")
    with pytest.raises(ValueError, match="supported pattern"):
        tt.StreamingEncoder(other)


# ---------------------------------------------------------------------------
# CorpusProcessor
# ---------------------------------------------------------------------------


@pytest.fixture
def corpus_files(tmp_path):
    rng = np.random.default_rng(8)
    files = []
    for i in range(6):
        p = tmp_path / "in" / f"doc{i}.txt"
        p.parent.mkdir(exist_ok=True)
        p.write_text(multiscript_text(rng, int(rng.integers(100, 6000)))
                     + ("<|bos|> more" if i % 2 else ""), encoding="utf-8")
        files.append(p)
    return files


def _shards(manifest):
    return {k: np.load(v["shard"]).tolist()
            for k, v in manifest["files"].items()}


def test_corpus_threads_equal_serial_and_jax(vocab, corpus_files, tmp_path):
    ranks, specials = vocab
    tok = _tok(vocab)
    serial = CorpusProcessor(tok, tmp_path / "s", num_threads=1,
                             allowed_special="all").process(corpus_files)
    threaded = CorpusProcessor(tok, tmp_path / "t", num_threads=4,
                               allowed_special="all").process(corpus_files)
    jtok = jtd.Tokenizer("t", pattern=tt.LLAMA4_PATTERN,
                         mergeable_ranks=ranks, special_tokens=specials,
                         backend="host")
    jax = JaxCorpusProcessor(jtok, tmp_path / "j", num_threads=1,
                             allowed_special="all").process(corpus_files)
    assert _shards(serial) == _shards(threaded) == _shards(jax)
    for f in corpus_files:
        e = threaded["files"][str(f.resolve())]
        assert e["status"] == "done" and e["tokens"] == len(
            np.load(e["shard"]))
        assert e["fingerprint"] == jax["files"][str(f.resolve())][
            "fingerprint"]


def test_corpus_resume(vocab, corpus_files, tmp_path):
    import os

    tok = _tok(vocab)
    out = tmp_path / "o"
    proc = CorpusProcessor(tok, out, num_threads=2)
    first = proc.process(corpus_files)
    assert len(first["files"]) == len(corpus_files)
    # a second run skips every file
    again = CorpusProcessor(tok, out, num_threads=2)
    again.process(corpus_files)
    assert again.meter.bytes == 0
    # a modified file is encoded again, the rest skipped
    corpus_files[2].write_text("changed text here", encoding="utf-8")
    st = corpus_files[2].stat()
    os.utime(corpus_files[2], (st.st_atime, st.st_mtime + 10))
    third = CorpusProcessor(tok, out, num_threads=2)
    m = third.process(corpus_files)
    assert third.meter.bytes == len("changed text here")
    assert np.load(m["files"][str(corpus_files[2].resolve())][
        "shard"]).tolist() == tok.encode("changed text here")
    # resume=False encodes everything
    fourth = CorpusProcessor(tok, out, num_threads=2)
    fourth.process(corpus_files, resume=False)
    assert fourth.meter.bytes == sum(
        len(f.read_text(encoding="utf-8").encode()) for f in corpus_files)


# ---------------------------------------------------------------------------
# encode_with_unstable
# ---------------------------------------------------------------------------

UNSTABLE_CASES = [
    "hello wor", "x   ", "the quick bro", "don'", "  \n\n  ",
    "café au lai", "a", "", "123,45", "def f(x", "наприм", "🙂", "é",
    "word  ", "tab\t\t", "x \n", "I'v", "HELLO WO", "snake_cas",
    "http://exa", " ", "\n", "...", "a ", "x ", "th", "the",
]


def test_encode_with_unstable_equals_jax_and_tiktoken(vocab):
    ranks, specials = vocab
    tok = _tok(vocab)
    jtok = jtd.Tokenizer("t", pattern=tt.LLAMA4_PATTERN,
                         mergeable_ranks=ranks, special_tokens=specials,
                         backend="host")
    tk = tiktoken.Encoding("t", pat_str=tt.LLAMA4_PATTERN,
                           mergeable_ranks=ranks, special_tokens=specials)
    for text in UNSTABLE_CASES + ["a <|bos|>", "a <|bos|> tra"]:
        kw = {"allowed_special": "all"} if "<|" in text else {}
        got = tok.encode_with_unstable(text, **kw)
        want = jtok.encode_with_unstable(text, **kw)
        oracle = tk.encode_with_unstable(text, **kw)
        assert got[0] == want[0] == oracle[0], text
        assert got[1] == want[1], text
        assert sorted(map(tuple, got[1])) == sorted(map(tuple, oracle[1])), (
            text)
    with pytest.raises(ValueError, match="disallowed special"):
        tok.encode_with_unstable("x <|bos|>")
