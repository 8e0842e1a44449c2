"""The stream path's id lists: ``tdpy.assemble_lists`` (one pass from
shared ints) against ``tolist()`` and Python assembly, its refusals, that a
cached id is one object and leaks no reference, and
``DeviceEngine(device="cpu")``'s ``encode_batch`` and
``encode_ordinary_batch`` through the extension and without it, against
``HostEngine``, with the counters ``listed_ids`` and ``listed_shared``."""

import sys

import numpy as np
import pytest

from conftest import make_tiny_vocab
from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine, HostEngine
from tokendagger_tpu_torch import native

PRIMED = 1 << 16          # ids [0, PRIMED) are in the shared table
OUTSIDE = 1 << 22         # the table's cap: never shared


@pytest.fixture
def tdpy():
    mod = native.get_pymod()
    if mod is None:
        pytest.skip("no CPython extension (Python.h or g++ missing)")
    mod.prime_longs(PRIMED)
    return mod


def _segment(rng, n: int, lo: int = 0, hi: int = PRIMED) -> np.ndarray:
    return rng.integers(lo, hi, size=n, dtype=np.int64)


def _case(name: str, rng) -> list[list]:
    """Texts, each a list of parts: special ids (int) and int64 arrays."""
    if name == "random":
        return [[_segment(rng, int(rng.integers(0, 3000))),
                 int(rng.integers(0, PRIMED)),
                 _segment(rng, int(rng.integers(0, 3000)))]
                for _ in range(7)]
    if name == "empty_segments":
        empty = np.zeros(0, dtype=np.int64)
        return [[empty], [empty, 5, empty], [_segment(rng, 4), empty]]
    if name == "only_specials":
        return [[300], [300, 301, 302], [0, 1, 255, 256, 257]]
    if name == "no_parts":
        return [[], [_segment(rng, 3)], []]
    if name == "no_texts":
        return []
    if name == "outside_table":
        return [[np.asarray([OUTSIDE, -1, 2**40, -(2**62), 7, PRIMED - 1],
                            dtype=np.int64), OUTSIDE + 5, -9],
                [_segment(rng, 100, OUTSIDE, OUTSIDE + 1000)]]
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["random", "empty_segments",
                                  "only_specials", "no_parts", "no_texts",
                                  "outside_table"])
def test_assemble_lists_equals_tolist(tdpy, name):
    texts = _case(name, np.random.default_rng(2**31 + 17))
    want = []
    for parts in texts:
        ids: list[int] = []
        for p in parts:
            if isinstance(p, int):
                ids.append(p)
            else:
                ids.extend(p.tolist())
        want.append(ids)
    lists, shared = tdpy.assemble_lists(texts)
    assert lists == want
    assert all(type(i) is int for ids in lists for i in ids)
    assert shared == sum(0 <= i < PRIMED for ids in want for i in ids)


def test_ids_outside_the_table_are_fresh_ints(tdpy):
    parts = [np.asarray([OUTSIDE, -3], dtype=np.int64), OUTSIDE]
    (a,), _ = tdpy.assemble_lists([parts])
    (b,), _ = tdpy.assemble_lists([parts])
    assert a == b == [OUTSIDE, -3, OUTSIDE]
    assert a[0] is not b[0] and a[0] is not a[2]


@pytest.mark.parametrize("part,error", [
    (np.arange(4, dtype=np.int32), TypeError),       # int32 ids
    (np.arange(4, dtype=np.uint64), TypeError),      # unsigned
    (np.arange(4, dtype=np.float64), TypeError),
    (b"01234567", TypeError),                        # bytes: format 'B'
    (np.arange(8, dtype=np.int64)[::2], ValueError),  # not contiguous
    ("12", TypeError),                               # no buffer
])
def test_assemble_lists_refuses_other_buffers(tdpy, part, error):
    with pytest.raises(error):
        tdpy.assemble_lists([[np.arange(3, dtype=np.int64)], [part]])


@pytest.mark.parametrize("texts", [[5], [[1], 2], None])
def test_assemble_lists_refuses_texts_not_sequences(tdpy, texts):
    with pytest.raises(TypeError):
        tdpy.assemble_lists(texts)


def test_cached_id_is_one_object_and_not_leaked(tdpy):
    seg = np.asarray([777, 778, 777], dtype=np.int64)
    (a,), _ = tdpy.assemble_lists([[seg, 777]])
    x = a[0]
    start = sys.getrefcount(x) - 4   # a holds it three times, x once
    (b,), shared = tdpy.assemble_lists([[seg]])
    assert shared == 3
    assert x is a[2] is a[3] is b[0] is b[2]
    assert sys.getrefcount(x) == start + 6
    del a, b
    assert sys.getrefcount(x) == start + 1


def _texts():
    rng = np.random.default_rng(2**33 + 5)
    words = ["hello", " the", " and", " is", " to", " there", "\n", " 123",
             " café", " 日本語", "  ", " world", "!"]

    def prose(n):
        return "".join(words[int(i)] for i in rng.integers(len(words),
                                                           size=n))
    return [
        prose(30) + "<|eos|>" + prose(20),        # short: a grid row each
        "<|bos|>", "", prose(3),
        "<|bos|>" + prose(400) + "<|eos|><|pad|>" + prose(2000),
        prose(16000),                             # over one 64 KB window
        prose(50) + "<|fim_prefix|>",
    ]


@pytest.mark.parametrize("route", ["extension", "fallback"])
def test_engine_lists_equal_host(monkeypatch, route):
    if route == "fallback":
        monkeypatch.setattr(native, "get_pymod", lambda: None)
    elif native.get_pymod() is None:
        pytest.skip("no CPython extension (Python.h or g++ missing)")
    ranks, specials = make_tiny_vocab()
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu")
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    texts = _texts()
    allowed = set(specials)

    got = eng.encode_batch(texts, allowed)
    assert got == [host.encode(t, allowed)[0] for t in texts]
    n = sum(map(len, got))
    ordinary = eng.encode_ordinary_batch(texts)
    assert ordinary == [host.encode_ordinary(t) for t in texts]
    n += sum(map(len, ordinary))
    assert all(type(i) is int for ids in got + ordinary for i in ids)
    assert eng.stats.listed_ids == n
    assert eng.stats.listed_shared == (n if route == "extension" else 0)
