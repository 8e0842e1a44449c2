"""The port's public API (``Tokenizer``/``Encoding``) on the CPU against an
offline ``tiktoken.Encoding`` built from the same ranks (the oracle) and
against the JAX package's ``Tokenizer`` with its device backend; plus the
decode op and the decode tables against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import tiktoken
import torch

import tokendagger_tpu as jtd
from tests.conftest import make_tiny_vocab
from tokendagger_tpu import tables as JT
from tokendagger_tpu.ops.decode import decode_ids as jax_decode_ids
from tokendagger_tpu_torch import (
    LLAMA4_PATTERN, Encoding, TokenDaggerError, Tokenizer, create_tokenizer,
    load_tokenizer,
)
from tokendagger_tpu_torch import convert as TCV
from tokendagger_tpu_torch import tables as TT
from tokendagger_tpu_torch.ops.decode import decode_ids
from torch_port_util import multiscript_text, prose_text

INLINE = [
    "",
    " ",
    "hello world",
    "Hello, World! How are you?",
    "it's don't we'll they've I'm you'd I'ſ WON'K",
    "unicode: café naïve résumé 日本語 русский العربية",
    "emoji: 🙂🙃 👍🏽 🇺🇸 👩‍👩‍👧‍👧",
    "code: def f(x):\n    return x**2  # comment\n",
    "whitespace:   \t\n  \r\n   end　　x",
    "<|bos|> special-looking text <|eos|> <|nope|>",
]


def _texts():
    rng = np.random.default_rng(21)
    return INLINE + [multiscript_text(rng, 70000), prose_text(rng, 20000)
                     + "<|pad|>" + multiscript_text(rng, 300)]


@pytest.fixture(scope="module")
def trio():
    """(port on the CPU, tiktoken oracle, JAX package's device backend)."""
    ranks, specials = make_tiny_vocab()
    kw = dict(pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
              special_tokens=specials)
    port = Encoding("tiny", device="cpu", **kw)
    oracle = tiktoken.Encoding("tiny", **kw)
    ref = jtd.Encoding("tiny", **kw)
    ref.backend = "tpu"
    return port, oracle, ref


def test_encode_ordinary_equals_oracle(trio):
    port, oracle, ref = trio
    for t in _texts():
        got = port.encode_ordinary(t)
        assert got == oracle.encode_ordinary(t), t[:40]
        assert got == ref.encode_ordinary(t), t[:40]


@pytest.mark.parametrize("allowed", ["all", {"<|bos|>"}, set()])
def test_encode_specials_equals_oracle(trio, allowed):
    port, oracle, ref = trio
    for t in _texts():
        kw = dict(allowed_special=allowed, disallowed_special=())
        got = port.encode(t, **kw)
        assert got == oracle.encode(t, **kw), t[:40]
        assert got == ref.encode(t, **kw), t[:40]
    assert port.encode_with_special_tokens(INLINE[-1]) == oracle.encode(
        INLINE[-1], allowed_special="all")


def test_disallowed_special_message_equals_oracle(trio):
    port, oracle, _ = trio
    text = "x <|eos|> y"
    with pytest.raises(ValueError) as got:
        port.encode(text)
    with pytest.raises(ValueError) as want:
        oracle.encode(text)
    assert str(got.value) == str(want.value)
    # a subset allowed: the others stay disallowed
    with pytest.raises(ValueError):
        port.encode(text, allowed_special={"<|bos|>"})
    assert port.encode(text, allowed_special={"<|eos|>"}) == oracle.encode(
        text, allowed_special={"<|eos|>"})


def test_encode_batch_equals_oracle(trio):
    port, oracle, ref = trio
    texts = _texts()
    want = [oracle.encode(t, disallowed_special=()) for t in texts]
    assert port.encode_batch(texts, disallowed_special=()) == want
    assert ref.encode_batch(texts, disallowed_special=()) == want
    assert port.encode_ordinary_batch(texts) == [
        oracle.encode_ordinary(t) for t in texts]
    arrays = port.encode_batch_np(texts, disallowed_special=())
    assert [a.tolist() for a in arrays] == want
    assert port.encode_to_numpy(texts[3]).dtype == np.uint32


def test_decode_round_trip(trio):
    port, oracle, ref = trio
    for t in _texts():
        ids = port.encode(t, allowed_special="all")
        assert port.decode(ids) == t
        assert port.decode_bytes(ids) == oracle.decode_bytes(ids)
        assert port.decode_bytes(ids) == ref.decode_bytes(ids)
    ids = port.encode_ordinary(_texts()[-2])
    assert len(ids) > 1000  # the device decode path
    assert port.decode_batch([ids, ids[:5]]) == oracle.decode_batch(
        [ids, ids[:5]])
    assert port.decode_bytes_batch([ids[:30]]) == [
        oracle.decode_bytes(ids[:30])]


def test_decode_unknown_id_raises(trio):
    port, _, _ = trio
    for ids in ([1, 2, 4000], [1] * 30 + [4000], [1] * 30 + [-1]):
        with pytest.raises(TokenDaggerError):
            port.decode_bytes(ids)


def test_attribute_surface_equals_oracle(trio):
    port, oracle, _ = trio

    def tryget(f):
        try:
            return ("val", f())
        except Exception as e:  # noqa: BLE001
            return ("exc", type(e).__name__)

    assert port.n_vocab == oracle.n_vocab
    assert port.max_token_value == oracle.max_token_value
    assert tryget(lambda: port.eot_token) == tryget(lambda: oracle.eot_token)
    assert port.special_tokens_set == oracle.special_tokens_set
    assert port.token_byte_values() == oracle.token_byte_values()
    ids = port.encode_ordinary("hello world test \U0001f642 héllo")
    assert port.decode_tokens_bytes(ids) == oracle.decode_tokens_bytes(ids)
    assert port.decode_with_offsets(ids) == oracle.decode_with_offsets(ids)
    bad = port.encode_ordinary("héllo")[:2]  # splits the multibyte char
    for errors in ("replace", "ignore"):
        assert port.decode(bad, errors=errors) == oracle.decode(
            bad, errors=errors)
    for probe in (b"<|bos|>", "<|bos|>", b"hello", b"\xff\xfe", b"zz",
                  "<|nope|>"):
        assert tryget(lambda: port.encode_single_token(probe)) == tryget(
            lambda: oracle.encode_single_token(probe)), probe
    assert tryget(lambda: port.decode_single_token_bytes(99999)) == tryget(
        lambda: oracle.decode_single_token_bytes(99999))
    assert port.is_special_token(5000) and not port.is_special_token(5)


@pytest.mark.parametrize("backend", ["host", "auto"])
def test_other_backends_equal_device(trio, backend):
    port, _, _ = trio
    ranks, specials = make_tiny_vocab()
    other = Tokenizer("tiny", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                      special_tokens=specials, backend=backend, device="cpu")
    for t in _texts():
        ids = port.encode(t, allowed_special="all")
        assert other.encode(t, allowed_special="all") == ids
        assert other.decode(ids) == port.decode(ids)


def test_default_backend_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend is valid")
    ranks, specials = make_tiny_vocab()
    for backend in ("device", "auto"):
        with pytest.raises(RuntimeError):
            Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                      special_tokens=specials, backend=backend)
    host = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                     special_tokens=specials, backend="host")
    assert host.encode_ordinary("hello") == [ranks[b"hello"]]


def test_unknown_pattern_raises_on_device():
    ranks, specials = make_tiny_vocab()
    tok = Tokenizer("t", pat_str=r"\w+|\s+", mergeable_ranks=ranks,
                    special_tokens=specials, device="cpu")
    with pytest.raises(TokenDaggerError, match="not ported"):
        tok.encode_ordinary("hello")


def test_factories(tmp_path):
    import json

    ranks, specials = make_tiny_vocab()
    vocab = [{"rank": r, "token_bytes": list(b), "token_string": ""}
             for b, r in ranks.items()]
    a = create_tokenizer("t", LLAMA4_PATTERN, vocab, specials, device="cpu")
    (tmp_path / "v.json").write_text(json.dumps(vocab))
    (tmp_path / "s.json").write_text(json.dumps(specials))
    b = load_tokenizer("t", tmp_path / "v.json", LLAMA4_PATTERN,
                       tmp_path / "s.json", device="cpu")
    text = "hello there, it's <|bos|> 🙂"
    want = a.encode(text, allowed_special="all")
    assert b.encode(text, allowed_special="all") == want
    assert Encoding("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, explicit_n_vocab=None,
                    device="cpu").encode(text, allowed_special="all") == want
    with pytest.raises(AssertionError):
        Encoding("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                 special_tokens=specials, explicit_n_vocab=7, device="cpu")


def test_decode_tables_equal_jax():
    ranks, specials = make_tiny_vocab()
    want = JT.build_tables(ranks, specials, use_cache=False)
    offs, lens, blob, n_vocab = TT.build_decode_tables(ranks, specials)
    assert np.array_equal(offs, want.decode_offsets)
    assert np.array_equal(lens, want.decode_lengths)
    assert np.array_equal(blob, want.decode_blob)
    assert n_vocab == want.n_vocab


def test_decode_ids_equals_jax():
    ranks, specials = make_tiny_vocab()
    offs, lens, blob, _ = TT.build_decode_tables(ranks, specials)
    rng = np.random.default_rng(5)
    ids = np.concatenate([rng.integers(0, 291, 500), [5000, 5003, 255]])
    for cap in (4096, 8192):
        want_out, want_total = jax_decode_ids(
            jnp.asarray(ids.astype(np.int32)), jnp.asarray(offs),
            jnp.asarray(lens), jnp.asarray(blob), cap)
        got_out, got_total = decode_ids(
            torch.from_numpy(ids), *(torch.from_numpy(a)
                                     for a in (offs, lens, blob)), cap)
        assert int(got_total) == int(want_total)
        assert np.array_equal(got_out.numpy(), np.asarray(want_out))


def test_engine_tables_from_reference():
    ranks, specials = make_tiny_vocab()
    ref = JT.build_tables(ranks, specials, use_cache=False)
    t = TCV.engine_tables_from_reference(
        ref.vhash8_rows, ref.vhash8_mask, ref.decode_offsets,
        ref.decode_lengths, ref.decode_blob, ref.n_vocab, device="cpu")
    own = TCV.engine_tables_from_ranks(ranks, specials, device="cpu")
    for name in ("vhash8_rows", "decode_offsets", "decode_lengths",
                 "decode_blob"):
        assert torch.equal(getattr(t, name), getattr(own, name)), name
    assert (t.vhash8_mask, t.n_vocab) == (own.vhash8_mask, own.n_vocab)
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, device="cpu", tables=t)
    text = multiscript_text(np.random.default_rng(1), 5000)
    ids = tok.encode_ordinary(text)
    assert ids == tiktoken.Encoding(
        "t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
        special_tokens=specials).encode_ordinary(text)
    assert tok.decode(ids) == text
    with pytest.raises(ValueError):
        TCV.engine_tables_from_reference(
            ref.vhash8_rows, ref.vhash8_mask, ref.decode_offsets[:-1],
            ref.decode_lengths, ref.decode_blob, ref.n_vocab, device="cpu")
