"""The splice of a device window's missed pieces (``splice.Splicer``) on
the CPU, under the cl100k and o200k patterns: its native route
(``td_splice`` through ``native.NativeSplicer``) gives the same ids as its
Python loop and as ``HostEngine.encode_ordinary`` on windows and grid
rows, with the same counters; a mismatched miss count raises on both
routes, and the Python route serves where the native table is missing,
refused, or meets a byte without a rank."""

import numpy as np
import pytest

from conftest import make_tiny_vocab
from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine, HostEngine
from tokendagger_tpu_torch import native
from tokendagger_tpu_torch.ops.fused import SENTINEL
from tokendagger_tpu_torch.splice import Splicer
from tokendagger_tpu_torch.vocab import CL100K_PATTERN

# o200k's pat_str is the port's llama4 profile
PATTERNS = {"cl100k": CL100K_PATTERN, "o200k": LLAMA4_PATTERN}
WORDS = ("get set http response handler value index buffer count user "
         "name file path token merge window piece").split()
LONG_TOKEN = b" supercalifragilistic"        # a whole token over 16 bytes
RUN_ALPHABET = "abcde"

needs_native = pytest.mark.skipif(native.get_lib() is None,
                                  reason="no C++ toolchain for tdnative.cpp")


def _identifier(rng) -> str:
    words = [WORDS[int(i)] for i in rng.integers(len(WORDS),
                                                  size=int(rng.integers(1, 5)))]
    if rng.random() < 0.5:
        return words[0] + "".join(w.capitalize() for w in words[1:])
    return "_".join(words)


def _run(rng, n: int) -> str:
    """One lowercase piece of ``n`` letters that the vocabulary merges far
    but never whole."""
    return "".join(RUN_ALPHABET[int(i)]
                   for i in rng.integers(len(RUN_ALPHABET), size=n))


def code_text(rng, n: int) -> str:
    """About ``n`` chars of code: camelCase and snake_case identifiers
    (camelCase misses, one piece under cl100k), the long token, and a miss
    of 96+ bytes (the heap merge) and one over 255 bytes now and then."""
    parts, size = [], 0
    while size < n:
        r = rng.random()
        if r < 0.02:
            s = f"    x = {_run(rng, int(rng.integers(96, 200)))}\n"
        elif r < 0.03:
            s = f"    y = {_run(rng, int(rng.integers(256, 400)))}\n"
        elif r < 0.08:
            s = f"    #{LONG_TOKEN.decode()} the\n"
        else:
            s = (f"    {_identifier(rng)} = {_identifier(rng)}"
                 f"({_identifier(rng)}, {int(rng.integers(100))});\n")
        parts.append(s)
        size += len(s)
    return "".join(parts)


def code_vocab():
    """The tiny vocabulary plus every word (with its prefixes, lower and
    capitalized, bare and after a space), the long token, and pairs and
    triples of the run alphabet, so that identifiers and runs merge far
    and camelCase identifiers stay absent: (ranks, specials)."""
    ranks, specials = make_tiny_vocab()
    nxt = 6000                               # above the specials' ids

    def add(tok: bytes):
        nonlocal nxt
        if tok not in ranks:
            ranks[tok] = nxt
            nxt += 1

    for w in WORDS:
        for form in (w, w.capitalize(), " " + w, "_" + w):
            b = form.encode()
            for k in range(2, len(b) + 1):
                add(b[:k])
    for k in range(2, len(LONG_TOKEN) + 1):
        add(LONG_TOKEN[:k])
    for a in RUN_ALPHABET:
        for b in RUN_ALPHABET:
            add((a + b).encode())
            for c in RUN_ALPHABET[:2]:
                add((a + b + c).encode())
    return ranks, specials


@pytest.fixture(scope="module", params=sorted(PATTERNS))
def setup(request):
    """(native engine, Python-route engine, host engine) for one pattern."""
    ranks, specials = code_vocab()
    pat = PATTERNS[request.param]
    nat = DeviceEngine(pat, ranks, specials, device="cpu")
    py = DeviceEngine(pat, ranks, specials, device="cpu")
    py._splicer.native = None
    return nat, py, HostEngine(pat, ranks, specials)


def _fresh(setup):
    """The fixture's engines with their counters zeroed, and the host."""
    from tokendagger_tpu_torch.engine import EngineStats

    nat, py, host = setup
    nat.stats, py.stats = EngineStats(), EngineStats()
    return nat, py, host


@needs_native
def test_the_engine_has_the_native_table_and_no_pair_table(setup):
    nat, _, _ = setup
    assert isinstance(nat._splicer, Splicer)
    assert isinstance(nat._splicer.native, native.NativeSplicer)
    assert nat._merge is None


@needs_native
@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("seed", [1, 2])
def test_windows_equal_the_python_loop_and_the_host(setup, seed, threads):
    """Windows of over a thousand misses each: on one thread, and on four
    (each with its own memo)."""
    nat, py, host = _fresh(setup)
    nat._splicer.native = native.NativeSplicer(nat.ranks, nat._byte_rank)
    nat._splicer.native.threads = threads
    rng = np.random.default_rng(seed)
    text = code_text(rng, 150_000)           # three CPU windows and more
    want = host.encode_ordinary(text)
    assert nat.encode_stream(text.encode()).tolist() == want
    assert py.encode_stream(text.encode()).tolist() == want
    a, b = nat.stats, py.stats
    assert a.windows >= 3 and a.cut_windows >= 2
    assert a.spliced_pieces >= 1024 * a.windows   # SPLICE_PARALLEL_MIN
    assert a.spliced_pieces == b.spliced_pieces > 0
    assert a.spliced_whole == b.spliced_whole > 0      # the long token
    assert a.spliced_whole < a.spliced_pieces
    assert a.spliced_native == a.spliced_pieces
    assert b.spliced_native == 0


@needs_native
@pytest.mark.parametrize("length", [96, 140, 255, 256, 300, 700])
def test_long_misses_merge_exactly(setup, length):
    """Misses of 96 bytes and more (the heap merge), and over 255 bytes,
    which no whole-piece lookup can hold."""
    nat, py, host = _fresh(setup)
    rng = np.random.default_rng(length)
    text = f"x = {_run(rng, length)} and{LONG_TOKEN.decode()} {_run(rng, 3)}"
    want = host.encode_ordinary(text)
    assert nat.encode_stream(text.encode()).tolist() == want
    assert py.encode_stream(text.encode()).tolist() == want
    assert nat.stats.spliced_native == nat.stats.spliced_pieces >= 2
    assert nat.stats.spliced_whole == py.stats.spliced_whole == 1


@needs_native
def test_a_window_without_misses_splices_nothing(setup):
    nat, _, host = _fresh(setup)
    text = " the and the is to" * 200
    assert nat.encode_stream(text.encode()).tolist() == (
        host.encode_ordinary(text))
    assert nat.stats.windows == 1
    assert nat.stats.spliced_pieces == nat.stats.spliced_native == 0


@needs_native
def test_grid_rows_equal_the_python_loop_and_the_host(setup):
    nat, py, host = _fresh(setup)
    rng = np.random.default_rng(5)
    segs = [code_text(rng, int(n)).encode()[:4000]
            for n in rng.integers(50, 3000, size=12)]
    segs = [s.decode("utf-8", errors="ignore").encode() for s in segs]
    want = [host.encode_ordinary(s.decode()) for s in segs]
    for eng in (nat, py):
        got = eng.encode_streams(segs)
        assert [g.tolist() for g in got] == want
        assert eng.stats.grids >= 1 and eng.stats.windows == 0
    assert nat.stats.spliced_pieces == py.stats.spliced_pieces > 0
    assert nat.stats.spliced_whole == py.stats.spliced_whole
    assert nat.stats.spliced_native == nat.stats.spliced_pieces
    assert py.stats.spliced_native == 0


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("sentinels", [1, 3])
def test_a_miss_count_that_disagrees_raises(setup, route, sentinels):
    nat, py, _ = setup
    eng = nat if route == "native" else py
    if route == "native" and eng._splicer.native is None:
        pytest.skip("no C++ toolchain for tdnative.cpp")
    ids = np.array([5, SENTINEL, 7] + [SENTINEL] * (sentinels - 1) + [9],
                   dtype=np.int64)
    window = b"abcdefgh"
    starts = np.array([0, 2, 4], dtype=np.int32)
    lens = np.array([2, 2, 2], dtype=np.int32)
    with pytest.raises(RuntimeError, match="SENTINEL slots for 2 missed"):
        eng._splicer.splice(ids, window, starts, lens, 2)
    if route == "native":                    # the route stays native
        assert eng._splicer.native is not None


def test_without_a_toolchain_the_python_loop_splices(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    ranks, specials = code_vocab()
    eng = DeviceEngine(CL100K_PATTERN, ranks, specials, device="cpu")
    assert eng._splicer.native is None
    text = code_text(np.random.default_rng(8), 20_000)
    assert eng.encode_stream(text.encode()).tolist() == HostEngine(
        CL100K_PATTERN, ranks, specials).encode_ordinary(text)
    assert eng.stats.spliced_pieces > 0
    assert eng.stats.spliced_native == 0


@needs_native
def test_a_refused_vocabulary_keeps_the_python_route():
    ranks, specials = code_vocab()
    ranks[b"q" * 300] = 9000                 # a token over 255 bytes
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu")
    assert eng._splicer.native is None
    text = f"x = {'q' * 300} y = {'q' * 301}" + code_text(
        np.random.default_rng(9), 5_000)
    assert eng.encode_stream(text.encode()).tolist() == HostEngine(
        LLAMA4_PATTERN, ranks, specials).encode_ordinary(text)
    assert eng.stats.spliced_whole >= 1      # the 300-byte token, whole
    assert eng.stats.spliced_native == 0


@needs_native
def test_a_byte_without_a_rank_falls_back_to_python():
    """A table that meets a byte without a rank reports it
    (``SPLICE_RANKLESS``); the Splicer drops the table and splices that
    window and the rest in Python, exactly."""
    ranks, specials = code_vocab()
    eng = DeviceEngine(CL100K_PATTERN, ranks, specials, device="cpu")
    holed = eng._byte_rank.copy()
    holed[ord("a")] = -1
    eng._splicer.native = native.NativeSplicer(ranks, holed)
    text = code_text(np.random.default_rng(10), 20_000)
    assert eng.encode_stream(text.encode()).tolist() == HostEngine(
        CL100K_PATTERN, ranks, specials).encode_ordinary(text)
    assert eng._splicer.native is None
    assert eng.stats.spliced_native == 0 < eng.stats.spliced_pieces
