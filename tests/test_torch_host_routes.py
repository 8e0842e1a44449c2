"""The port's ``Tokenizer`` routes through the native host engine against
the JAX package's ``Tokenizer``, exactly: every encode and decode entry
point of ``backend="host"``, with and without specials, the full and a
subset allowed set, for the four profiles, the intra-text split and
``num_threads``; the exception type of every encode entry point on a lone
surrogate (host and device backends); and "auto"'s routing between the
native engine and the device."""

import numpy as np
import pytest

import tokendagger_tpu as jtd
from tests.conftest import make_tiny_vocab
from tokendagger_tpu_torch import Tokenizer
from tokendagger_tpu_torch.hostengine import HostEngine
from tokendagger_tpu_torch.vocab import (
    CL100K_PATTERN, GPT2_PATTERN, LLAMA4_PATTERN, TEKKEN_PATTERN,
)
from torch_port_util import collision_vocab, multiscript_text, prose_text

PROFILES = {"llama4": LLAMA4_PATTERN, "nocontract": TEKKEN_PATTERN,
            "cl100k": CL100K_PATTERN, "gpt2": GPT2_PATTERN}
SPLIT = (
    "alpha\nbeta gamma.\nDelta?!\nepsilon x/\nyellow\r\nword "
    "it's\nthey're CAN'T\nSHOUTING ABC\nDEF 1234567 abc 42 x "
    "café\nétude naïve\nz 1,234.56 €99 ...!!!???\nq "
    "x         y tab\tsep\na.b.c a-b-c snake_case camelCase "
    "\n\n\nblank lines\n\n\nend 日本語\nascii mix𝒳\ny "
)


def _vocab(kind):
    if kind == "tiny":
        return make_tiny_vocab()
    ranks, _ = collision_vocab(seed=5)
    n = max(ranks.values()) + 1
    return ranks, {"<|bos|>": n, "<|eos|>": n + 1, "<|pad|>": n + 2}


def _pair(pattern, ranks, specials, **kw):
    kw = dict(pattern=pattern, mergeable_ranks=ranks,
              special_tokens=specials, **kw)
    return (Tokenizer("t", backend="host", **kw),
            jtd.Tokenizer("t", backend="host", **kw))


@pytest.fixture(scope="module", params=[
    (p, v) for p in PROFILES for v in ("tiny", "collision")],
    ids=lambda pv: f"{pv[0]}-{pv[1]}")
def pair(request):
    profile, kind = request.param
    ranks, specials = _vocab(kind)
    port, ref = _pair(PROFILES[profile], ranks, specials)
    if port._get_native() is None:
        pytest.skip("no C++ toolchain")
    assert port.host_binding == "extension"
    assert ref._get_native() is not None
    return port, ref, HostEngine(PROFILES[profile], ranks, specials)


def _texts(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    out = ["", " ", "hello world", "it's 12345 don't", "<|bos|>",
           "a<|eos|>b<|bos|><|pad|>c", "  \r\n x <|pad|>"]
    for _ in range(4):
        parts = []
        for _ in range(int(rng.integers(1, 8))):
            parts.append(multiscript_text(rng, int(rng.integers(0, 1500))))
            parts.append(["<|bos|>", "<|eos|>", "<|pad|>", "x"][
                int(rng.integers(4))])
        out.append("".join(parts))
    out.append(prose_text(rng, 20000))
    return out


def _allowed_sets(specials):
    return ["all", {next(iter(specials))}, set()]


def test_encode_entry_points_equal(pair):
    port, ref, host = pair
    specials = host.special_tokens
    for t in _texts(1):
        want = host.encode_ordinary(t)
        assert port.encode_ordinary(t) == want
        assert ref.encode_ordinary(t) == want
        for allowed in _allowed_sets(specials):
            kw = dict(allowed_special=allowed, disallowed_special=())
            got = port.encode(t, **kw)
            assert got == ref.encode(t, **kw), (allowed, t[:40])
            a = set(specials) if allowed == "all" else allowed
            assert got == host.encode(t, a)[0]
            npy = port.encode_to_numpy(t, **kw)
            assert npy.dtype == np.uint32 and npy.tolist() == got
        assert port.encode_with_special_tokens(t) == (
            ref.encode_with_special_tokens(t))


@pytest.mark.parametrize("num_threads", [1, 4])
def test_batch_entry_points_equal(pair, num_threads):
    port, ref, host = pair
    texts = _texts(2)
    for allowed in _allowed_sets(host.special_tokens):
        kw = dict(num_threads=num_threads, allowed_special=allowed,
                  disallowed_special=())
        got = port.encode_batch(texts, **kw)
        assert got == ref.encode_batch(texts, **kw), allowed
        a = set(host.special_tokens) if allowed == "all" else allowed
        assert got == [host.encode(t, a)[0] for t in texts]
        arrays = port.encode_batch_np(texts, **kw)
        want = ref.encode_batch_np(texts, **kw)
        assert [x.tolist() for x in arrays] == got
        assert [x.dtype for x in arrays] == [x.dtype for x in want]
    assert port.encode_ordinary_batch(texts, num_threads=num_threads) == (
        ref.encode_ordinary_batch(texts, num_threads=num_threads))


def test_threads_change_no_id(pair):
    port, _, _ = pair
    texts = _texts(3) * 3
    one = port.encode_batch(texts, num_threads=1, allowed_special="all")
    assert port.encode_batch(texts, num_threads=4,
                             allowed_special="all") == one
    assert port.encode_batch(texts, num_threads=64,
                             allowed_special="all") == one


def test_decode_entry_points_equal(pair):
    port, ref, host = pair
    for t in _texts(4):
        ids = host.encode(t, set(host.special_tokens))[0]
        for form in (ids, tuple(ids), np.asarray(ids, np.int64),
                     np.asarray(ids, np.int32)):
            assert port.decode_bytes(form) == ref.decode_bytes(form)
            assert port.decode(form) == ref.decode(form)
        assert port.decode_bytes(ids) == host.decode_bytes(ids)
        assert port.decode_batch([ids, ids[:7]], num_threads=3) == (
            ref.decode_batch([ids, ids[:7]], num_threads=3))
        assert port.decode_bytes_batch([ids, ids[:30]]) == (
            ref.decode_bytes_batch([ids, ids[:30]]))
        assert port.decode_tokens_bytes(ids[:50]) == (
            ref.decode_tokens_bytes(ids[:50]))
    bad = [1] * 30 + [10 ** 7]
    for form in (bad, np.asarray(bad)):
        with pytest.raises(Exception) as pe:
            port.decode_bytes(form)
        with pytest.raises(Exception) as re_:
            ref.decode_bytes(form)
        assert type(pe.value).__name__ == type(re_.value).__name__
        assert str(pe.value) == str(re_.value)


@pytest.mark.parametrize("profile", list(PROFILES))
def test_split_path_equals(profile, monkeypatch):
    """Texts past _SPLIT_MIN_BYTES (lowered to 4 KB) are cut at provable
    piece boundaries and encoded across cores: the same ids as the JAX
    package's split and the host engine's serial encode."""
    ranks, specials = make_tiny_vocab()
    port, ref = _pair(PROFILES[profile], ranks, specials)
    native = port._get_native()
    if native is None:
        pytest.skip("no C++ toolchain")
    for cls in (Tokenizer, jtd.Tokenizer):
        monkeypatch.setattr(cls, "_SPLIT_MIN_BYTES", 1 << 12)
    host = HostEngine(PROFILES[profile], ranks, specials)
    text = SPLIT * 200                                   # ~50 KB
    data = text.encode()
    got = port._encode_split_parallel(native, data)
    if got is None:
        pytest.skip("one core: the split needs two")
    want = host.encode_ordinary(text)
    assert got == want
    assert port.encode_ordinary(text) == want == ref.encode_ordinary(text)
    sp = text[:30000] + "<|bos|>" + text[30000:]
    assert port.encode(sp, allowed_special="all") == (
        host.encode(sp, set(specials))[0])
    assert port.encode(sp, allowed_special="all") == (
        ref.encode(sp, allowed_special="all"))
    assert port.encode_ordinary_batch([text, "x"]) == [want, [ord("x")]]
    emoji = ("🙂🇺🇸👍🏽" * 2000).encode()
    assert port._encode_split_parallel(native, emoji) is None


def test_effective_threads(monkeypatch):
    import os

    monkeypatch.delenv("TOKENDAGGER_NO_THREAD_CAP", raising=False)
    cores = os.cpu_count()
    assert Tokenizer._effective_threads(10 ** 6) == cores
    assert Tokenizer._effective_threads(0) == 1
    assert Tokenizer._effective_threads(1) == 1
    monkeypatch.setenv("TOKENDAGGER_NO_THREAD_CAP", "1")
    assert Tokenizer._effective_threads(10 ** 6) == 10 ** 6
    for n in (0, 3, 10 ** 6):
        assert Tokenizer._effective_threads(n) == (
            jtd.Tokenizer._effective_threads(n))


# --------------------------------------------------------------------------
# F6: the exception types of the encode entry points
# --------------------------------------------------------------------------
SURROGATE = "a\ud800b"
ENTRY_POINTS = {
    "encode": lambda t: t.encode(SURROGATE),
    "encode_all": lambda t: t.encode(SURROGATE, allowed_special="all"),
    "encode_ordinary": lambda t: t.encode_ordinary(SURROGATE),
    "encode_with_special_tokens":
        lambda t: t.encode_with_special_tokens(SURROGATE),
    "encode_batch": lambda t: t.encode_batch(["x", SURROGATE]),
    "encode_batch_all":
        lambda t: t.encode_batch([SURROGATE], allowed_special="all"),
    "encode_ordinary_batch": lambda t: t.encode_ordinary_batch([SURROGATE]),
    "encode_batch_np": lambda t: t.encode_batch_np([SURROGATE]),
    "encode_to_numpy": lambda t: t.encode_to_numpy(SURROGATE),
}


@pytest.fixture(scope="module", params=["host", "device"])
def backends(request):
    ranks, specials = make_tiny_vocab()
    kw = dict(pattern=LLAMA4_PATTERN, mergeable_ranks=ranks,
              special_tokens=specials)
    if request.param == "host":
        return (Tokenizer("t", backend="host", **kw),
                jtd.Tokenizer("t", backend="host", **kw))
    return (Tokenizer("t", backend="device", device="cpu", **kw),
            jtd.Tokenizer("t", backend="tpu", **kw))


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_surrogate_exception_type_equals(backends, entry):
    port, ref = backends
    call = ENTRY_POINTS[entry]
    with pytest.raises(Exception) as got:
        call(port)
    with pytest.raises(Exception) as want:
        call(ref)
    assert type(got.value).__name__ == type(want.value).__name__
    assert isinstance(got.value, ValueError) == isinstance(want.value,
                                                           ValueError)


# --------------------------------------------------------------------------
# Item 17: "auto" between the native engine and the device
# --------------------------------------------------------------------------
def _auto(**kw):
    ranks, specials = make_tiny_vocab()
    return Tokenizer("t", pattern=LLAMA4_PATTERN, mergeable_ranks=ranks,
                     special_tokens=specials, backend="auto", device="cpu",
                     **kw), HostEngine(LLAMA4_PATTERN, ranks, specials)


def test_auto_on_cpu_routes_to_native():
    tok, host = _auto()
    if tok._get_native() is None:
        pytest.skip("no C++ toolchain")
    assert tok._device_dispatch_ms() == float("inf")
    assert not tok._use_device(1 << 30) and not tok._use_device(100)
    text = SPLIT * 300
    assert tok.encode(text) == host.encode_ordinary(text)
    ids = tok.encode_ordinary(text)
    assert tok.decode(ids) == text
    assert tok._device is None and tok._decode is None


def test_auto_sends_large_inputs_to_a_fast_device(monkeypatch):
    tok, host = _auto()
    if tok._get_native() is None:
        pytest.skip("no C++ toolchain")
    monkeypatch.setattr(Tokenizer, "_DEVICE_AUTO_MIN_BYTES", 1 << 15)
    monkeypatch.setattr(Tokenizer, "_device_dispatch_ms", lambda self: 0.01)
    small, large = "hello world " * 100, SPLIT * 300        # 1.2 / 75 KB
    assert tok.encode(small) == host.encode_ordinary(small)
    assert tok._device is None
    assert tok.encode(large) == host.encode_ordinary(large)
    assert tok._device is not None
    # a slow dispatch keeps even large inputs on the native engine
    slow, _ = _auto()
    monkeypatch.setattr(Tokenizer, "_device_dispatch_ms", lambda self: 5.0)
    assert not slow._use_device(1 << 24)
    assert slow.encode(large) == host.encode_ordinary(large)
    assert slow._device is None


def test_auto_without_native_routes_by_size(monkeypatch):
    from tokendagger_tpu_torch import native as TN

    monkeypatch.setattr(TN, "get_lib", lambda: None)
    tok, host = _auto()
    assert tok.host_binding == "python"
    assert not tok._use_device(Tokenizer._DEVICE_MIN_BYTES - 1)
    assert tok._use_device(Tokenizer._DEVICE_MIN_BYTES)
    text = SPLIT * 100
    assert tok.encode(text) == host.encode_ordinary(text)
    assert tok._device is not None
