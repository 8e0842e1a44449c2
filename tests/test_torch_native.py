"""The port's native C++ host engine (``tokendagger_tpu_torch/native``)
against the JAX package's and against the port's pure-Python
``HostEngine``, exactly, for the four scanner profiles; its decode entry
points; the ctypes-only route; and a build check that fails when g++ is
present but a library does not build."""

import random
import shutil

import numpy as np
import pytest

from tests.conftest import make_tiny_vocab
from tokendagger_tpu import native as JN
from tokendagger_tpu.tables import build_tables as jax_build_tables
from tokendagger_tpu_torch import native as TN
from tokendagger_tpu_torch import tables as TT
from tokendagger_tpu_torch.hostengine import HostEngine
from tokendagger_tpu_torch.vocab import (
    CL100K_PATTERN, GPT2_PATTERN, LLAMA4_PATTERN, TEKKEN_PATTERN,
)
from fuzz_scanner import EDGE_TEXTS, random_text
from torch_port_util import collision_vocab, multiscript_text, prose_text

PROFILES = {"llama4": LLAMA4_PATTERN, "nocontract": TEKKEN_PATTERN,
            "cl100k": CL100K_PATTERN, "gpt2": GPT2_PATTERN}


def test_native_builds_when_toolchain_present():
    """A broken tdnative.cpp or tdpy.cpp must fail the suite, not fall
    back to the Python engine unseen."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    assert TN.get_lib() is not None, "native library failed to build"
    assert TN.get_pymod() is not None, "CPython extension failed to build"
    assert TN.binding() == "extension"
    assert TN._build() is not None and TN._build().parent.name == "_build"


def _vocab(kind):
    if kind == "tiny":
        return make_tiny_vocab()
    ranks, _ = collision_vocab(seed=3)
    n = max(ranks.values()) + 1
    return ranks, {"<|bos|>": n, "<|eos|>": n + 1, "<|bos|>x": n + 2}


def _texts(seed: int) -> list[str]:
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    return (list(EDGE_TEXTS) + [random_text(rng) for _ in range(60)]
            + [multiscript_text(nrng, 3000), prose_text(nrng, 3000)])


def _special_texts(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    sp = ["<|bos|>", "<|eos|>", "<|bos|>x", "<|pad|>", "<|fim_prefix|>"]
    out = ["", "<|bos|>", "<|bos|><|bos|>x<|eos|>", "a<|eos|>b<|bos|>xx"]
    for _ in range(6):
        parts = []
        for _ in range(int(rng.integers(1, 12))):
            parts.append(multiscript_text(rng, int(rng.integers(0, 200))))
            parts.append(sp[int(rng.integers(len(sp)))])
        out.append("".join(parts))
    return out


@pytest.fixture(scope="module", params=[
    (p, v) for p in PROFILES for v in ("tiny", "collision")],
    ids=lambda pv: f"{pv[0]}-{pv[1]}")
def engines(request):
    """(port NativeEngine, JAX NativeEngine, port HostEngine, specials)."""
    profile, kind = request.param
    if TN.get_lib() is None or JN.get_lib() is None:
        pytest.skip("no C++ toolchain")
    ranks, specials = _vocab(kind)
    pair = TT.build_pair_table(ranks)
    port = TN.NativeEngine(pair.rows, pair.mask, TT.byte_rank(ranks),
                           profile=profile, ranks=ranks)
    jt = jax_build_tables(ranks, specials)
    ref = JN.NativeEngine(jt.pair.rows, jt.pair.mask, jt.byte_rank,
                          profile=profile, ranks=ranks)
    assert port.set_specials(specials) and ref.set_specials(specials)
    host = HostEngine(PROFILES[profile], ranks, specials)
    return port, ref, host, specials


def test_scan_equals(engines):
    port, ref, host, _ = engines
    for t in _texts(1):
        data = t.encode()
        got = port.scan(data)
        assert got.tolist() == ref.scan(data).tolist(), repr(t[:40])
        offs = np.cumsum([0] + [len(c.encode()) for c in t])
        want = [int(offs[a]) for a, _ in host.split_spans(t)] + [len(data)]
        assert got.tolist() == want, repr(t[:40])


def test_encode_equals(engines):
    port, ref, host, _ = engines
    for t in _texts(2):
        data = t.encode()
        want = host.encode_ordinary(t)
        assert port.encode(data).tolist() == want, repr(t[:40])
        assert ref.encode(data).tolist() == want
        assert port.encode_list(data) == want
        assert ref.encode_list(data) == want


@pytest.mark.parametrize("num_threads", [1, 4])
def test_batch_entry_points_equal(engines, num_threads):
    port, ref, host, _ = engines
    texts = _texts(3)
    datas = [t.encode() for t in texts]
    want = [host.encode_ordinary(t) for t in texts]
    got = port.encode_batch(datas, num_threads)
    assert [a.tolist() for a in got] == want
    assert [a.tolist() for a in ref.encode_batch(datas, num_threads)] == want
    assert port.encode_batch_lists(datas, num_threads) == want
    assert ref.encode_batch_lists(datas, num_threads) == want
    blob = b"".join(datas)
    offs = np.zeros(len(datas) + 1, np.int64)
    offs[1:] = np.cumsum([len(d) for d in datas])
    assert port.encode_slices_lists(blob, offs, num_threads) == want
    assert ref.encode_slices_lists(blob, offs, num_threads) == want
    assert port.encode_batch([], num_threads) == []
    assert port.encode_batch_lists([], num_threads) == []


def test_specials_equal(engines):
    port, ref, host, specials = engines
    by_id = {i: s for s, i in specials.items()}
    for t in _special_texts(4):
        data = t.encode()
        pos, ids, lens = port.find_specials_l(data)
        rpos, rids = ref.find_specials(data)
        assert pos.tolist() == rpos.tolist() and ids.tolist() == rids.tolist()
        assert lens.tolist() == [len(by_id[i].encode()) for i in ids.tolist()]
        want = [(len(t[:p].encode()), specials[name])
                for p, name in host.find_all_specials(t, set(specials))]
        assert list(zip(pos.tolist(), ids.tolist())) == want, repr(t[:60])
        assert all(data[p:].startswith(by_id[i].encode())
                   for p, i in zip(pos.tolist(), ids.tolist()))
        full = host.encode(t, set(specials))[0]
        for n in (1, 4):
            assert port.encode_with_specials(data, num_threads=n) == full
            assert ref.encode_with_specials(data, num_threads=n) == full


def test_decode_entry_points():
    ranks, specials = make_tiny_vocab()
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    offs, lens, blob, _ = TT.build_decode_tables(ranks, specials)
    rng = np.random.default_rng(5)
    known = sorted(ranks.values()) + sorted(specials.values())
    ids = [known[i] for i in rng.integers(0, len(known), 3000)]
    want = host.decode_bytes(ids)
    assert TN.decode_ids(np.asarray(ids, np.int64), offs, lens, blob) == want
    assert TN.decode_list(ids, offs, lens, blob) == want
    assert TN.decode_list(tuple(ids), offs, lens, blob, nthreads=1) == want
    assert TN.decode_ids(np.empty(0, np.int64), offs, lens, blob) == b""
    for bad in (4000, -1, 10 ** 6):
        arr = np.asarray(ids[:50] + [bad], np.int64)
        with pytest.raises(KeyError, match=f"Unknown token id: {bad}"):
            TN.decode_ids(arr, offs, lens, blob)
        with pytest.raises(KeyError):
            TN.decode_list(arr.tolist(), offs, lens, blob)
        with pytest.raises(KeyError):
            host.decode_bytes(arr.tolist())


def test_ctypes_only_route(monkeypatch):
    """Without the CPython extension (a machine without Python.h) the
    ctypes library serves every entry point, and the Tokenizer says so."""
    from tokendagger_tpu_torch import Tokenizer

    if TN.get_lib() is None:
        pytest.skip("no C++ toolchain")
    monkeypatch.setattr(TN, "get_pymod", lambda: None)
    ranks, specials = make_tiny_vocab()
    pair = TT.build_pair_table(ranks)
    eng = TN.NativeEngine(pair.rows, pair.mask, TT.byte_rank(ranks),
                          profile="llama4", ranks=ranks)
    assert eng.binding == "ctypes" and eng._py is None
    assert eng.encode_list(b"hello") is None
    assert eng.encode_batch_lists([b"hello"]) is None
    assert TN.binding() == "ctypes"
    offs, lens, blob, _ = TT.build_decode_tables(ranks, specials)
    assert TN.decode_list([1, 2], offs, lens, blob) is None
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, backend="host")
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    assert tok.host_binding == "ctypes"
    assert not tok._decode_batch_serial()
    rng = np.random.default_rng(6)
    texts = [multiscript_text(rng, 2000) + "<|bos|>" for _ in range(5)]
    for t in texts:
        assert tok.encode(t, allowed_special="all") == host.encode(
            t, set(specials))[0]
        assert tok.encode_ordinary(t) == host.encode_ordinary(t)
    assert tok.encode_batch(texts, disallowed_special=()) == [
        host.encode_ordinary(t) for t in texts]
    ids = host.encode_ordinary(texts[0])
    assert tok.decode_batch([ids, ids[:3]]) == [
        host.decode_bytes(ids).decode("utf-8", "replace"),
        host.decode_bytes(ids[:3]).decode("utf-8", "replace")]
    assert tok.decode_bytes(np.asarray(ids)) == host.decode_bytes(ids)


def test_python_route_without_toolchain(monkeypatch):
    """No C++ toolchain: the Tokenizer keeps the pure-Python engine."""
    from tokendagger_tpu_torch import Tokenizer

    monkeypatch.setattr(TN, "get_lib", lambda: None)
    monkeypatch.setattr(TN, "get_pymod", lambda: None)
    ranks, specials = make_tiny_vocab()
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, backend="host")
    assert tok.host_binding == "python" and tok._get_native() is None
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    t = "hello <|bos|> world " * 20
    ids = tok.encode(t, allowed_special="all")
    assert ids == host.encode(t, set(specials))[0]
    assert tok.decode_bytes(ids) == host.decode_bytes(ids)
    assert tok.decode_bytes(np.asarray(ids)) == host.decode_bytes(ids)
    assert tok.encode_batch_np([t], allowed_special="all")[0].tolist() == ids


def test_refused_vocabulary_keeps_python():
    """A token over 255 bytes: the native engine refuses the vocabulary
    and the Tokenizer keeps the pure-Python engine, with the same ids."""
    from tokendagger_tpu_torch import Tokenizer

    ranks, specials = make_tiny_vocab()
    ranks[b"x" * 300] = max(ranks.values()) + 1
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, backend="host")
    assert tok.host_binding == "python"
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    t = "x" * 300 + " hello"
    assert tok.encode_ordinary(t) == host.encode_ordinary(t)
