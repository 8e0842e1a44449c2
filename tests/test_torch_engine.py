"""The port's DeviceEngine on the CPU (every kernel's plain version) held
against the JAX package's DeviceEngine on the CPU and the host engine:
one window at a time, whole streams with safe cuts, grown windows and the
host route, and the special-token split."""

import numpy as np
import pytest

from tests.conftest import make_tiny_vocab
from tokendagger_tpu.engine import DeviceEngine as JaxEngine
from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine, HostEngine
from tokendagger_tpu_torch.engine import CPU_WINDOW
from tokendagger_tpu_torch.vocab import CL100K_PATTERN, GPT2_PATTERN
from torch_port_util import multiscript_text, prose_text


@pytest.fixture(scope="module")
def engines():
    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(3)
    # whole-piece hits for some multi-script pieces, so both probe
    # outcomes occur on non-ASCII text
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    sample = multiscript_text(rng, 4000)
    for a, b in host.split_spans(sample):
        ranks.setdefault(sample[a:b].encode(), len(ranks) + 6000)
    return _trio(ranks, specials)


@pytest.fixture(scope="module")
def tiny():
    """The tiny vocab alone: it merges no run of one repeated char, so the
    host encodes of the long runs below stay linear."""
    return _trio(*make_tiny_vocab())


def _trio(ranks, specials):
    return (DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu"),
            JaxEngine(LLAMA4_PATTERN, ranks, specials),
            HostEngine(LLAMA4_PATTERN, ranks, specials))


def _window(rng, n: int) -> bytes:
    """About n bytes of multi-script text, cut at a char boundary."""
    raw = multiscript_text(rng, n).encode()[:n]
    return raw.decode("utf-8", errors="ignore").encode()


def test_window_size_matches_jax_cpu_engine(engines):
    port, jax_engine, _ = engines
    assert port._window == jax_engine._window == CPU_WINDOW
    assert port._max_window == jax_engine._max_window


@pytest.mark.parametrize("case", ["full", "cut", "small", "ascii", "none",
                                  "overflow"])
def test_fused_window_equals_jax(engines, case):
    port, jax_engine, _ = engines
    rng = np.random.default_rng(len(case))
    if case == "ascii":
        window = prose_text(rng, 30000).encode()
    elif case == "overflow":
        window = ("a " * CPU_WINDOW)[:CPU_WINDOW].encode()
    else:
        window = _window(rng, CPU_WINDOW if case != "small" else 3000)
    trim = {"cut": len(window) // 2, "none": 0}.get(case, len(window))
    if case == "cut":
        trim = port._safe_cut_threshold(window)
        assert trim == jax_engine._safe_cut_threshold(window) > 0
    # the one window executor, on a batch of one window with its trim
    (got_ids, got_consumed), = port._run_windows([(window, trim)])
    want_ids, want_consumed = jax_engine._fused_window(window, trim)
    assert got_consumed == want_consumed
    if case == "overflow":
        assert got_ids is None and want_ids is None
        return
    assert got_ids.dtype == np.int64
    assert got_ids.tolist() == want_ids.tolist()


def test_encode_stream_multiscript(engines):
    port, jax_engine, host = engines
    text = multiscript_text(np.random.default_rng(8), 150000)
    before = port.stats.windows
    got = port.encode_stream(text.encode())
    assert port.stats.windows - before >= 4    # several safe cuts
    assert got.tolist() == jax_engine.encode_stream(text.encode()).tolist()
    assert got.tolist() == host.encode_ordinary(text)


def test_ws_run_crossing_window_cut():
    ranks = {bytes([i]): i for i in range(256)}
    ranks[b"\n "] = 256
    ranks[b"  "] = 257
    ranks[b" \n"] = 258
    port = DeviceEngine(LLAMA4_PATTERN, ranks, {}, device="cpu")
    host = HostEngine(LLAMA4_PATTERN, ranks, {})
    text = "x" * 56000 + "\n" + " " * 12000 + "\n" + "b"
    got = port.encode_stream(text.encode())
    assert got.tolist() == host.encode_ordinary(text)
    want = JaxEngine(LLAMA4_PATTERN, ranks, {}).encode_stream(text.encode())
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("text", [
    "hello " * 100 + " " * 70000 + "\n" + "tail",
    " " * 140000 + "\nx",                      # run spans everything
    "a" * 100000 + " done",                    # letters run
    " " * 90000 + "\n" + "the quick brown fox " * 40,
    "b" * 70000 + " " * 70000 + "9" * 70000 + "." * 70000,
    "　" * 30000 + "\nx y z",              # unicode whitespace
], ids=["ws-run", "all-ws", "letters", "ws-then-prose", "four-runs",
        "ideographic-space"])
def test_runs_longer_than_window(tiny, text):
    port, jax_engine, host = tiny
    before = port.stats.host_advance_windows
    got = port.encode_stream(text.encode())
    assert port.stats.host_advance_windows > before
    assert got.tolist() == host.encode_ordinary(text)
    assert got.tolist() == jax_engine.encode_stream(text.encode()).tolist()


def test_overflow_takes_host_route(tiny):
    port, jax_engine, host = tiny
    text = prose_text(np.random.default_rng(2), 20000) + "a " * 40000 + "end"
    before = port.stats.host_advance_windows
    got = port.encode_stream(text.encode())
    assert port.stats.host_advance_windows > before
    assert got.tolist() == host.encode_ordinary(text)
    assert got.tolist() == jax_engine.encode_stream(text.encode()).tolist()


def test_encode_batch_with_specials(engines):
    port, jax_engine, host = engines
    rng = np.random.default_rng(4)
    texts = [
        "<|bos|>" + multiscript_text(rng, 3000) + "<|eos|>",
        "no specials here, café 🙂",
        "<|bos|><|bos|>x<|pad|>",
        "",
        multiscript_text(rng, 70000) + "<|fim_prefix|>" + "tail <|eos",
    ]
    for allowed in (set(host.special_tokens), {"<|bos|>"}, set()):
        got = port.encode_batch(texts, allowed)
        want = [host.encode(t, allowed)[0] for t in texts]
        assert got == want
        assert got == jax_engine.encode_batch(texts, allowed)
    assert port.encode_ordinary_batch(texts) == [
        host.encode_ordinary(t) for t in texts]


@pytest.mark.parametrize("pattern", [CL100K_PATTERN, GPT2_PATTERN])
def test_other_profiles_equal_host(pattern):
    ranks, specials = make_tiny_vocab()
    port = DeviceEngine(pattern, ranks, specials, device="cpu")
    host = HostEngine(pattern, ranks, specials)
    text = multiscript_text(np.random.default_rng(12), 80000)
    assert port.encode_stream(text.encode()).tolist() == host.encode_ordinary(
        text)


# the cases of the JAX package's tests/test_device_engine.py TestMergeKernel
PIECES = [b"hello", b"the", b"and", b"x", b"", b"hellohello",
          b"abcdefghijklmnop", b"a" * 16, b"a" * 63, b"!" * 10,
          bytes(range(256))[:64], b" there", b"is", b"ing", b"anding",
          b"x" * 300, b"-" * 1000, b"a" * 256, b"a" * 257]


@pytest.mark.parametrize("fastpath", [True, False])
def test_encode_pieces_equals_jax(fastpath):
    """encode_pieces with and without the whole-piece fast path equals
    the JAX DeviceEngine's and byte_pair_encode, random pieces included."""
    from tokendagger_tpu_torch import byte_pair_encode

    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(42)
    pieces = PIECES + [bytes(rng.integers(0, 256, int(k)).astype(np.uint8))
                       for k in rng.integers(1, 40, 100)]
    port = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu",
                        vocab_fastpath=fastpath)
    jax_eng = JaxEngine(LLAMA4_PATTERN, ranks, specials,
                        vocab_fastpath=fastpath)
    got = port.encode_pieces(pieces)
    assert got == jax_eng.encode_pieces(pieces)
    assert got == [byte_pair_encode(p, ranks) if p else [] for p in pieces]
    st = port.stats
    assert st.piece_host_merges == 3           # the three over 256 bytes
    assert set(st.merge_rows_by_width) == {16, 64, 256}
    if not fastpath:                           # vocab tokens merge too
        assert st.piece_hits > 0


def _piece_tokenizers():
    """Tokenizers the stream path cannot serve: a pattern outside the four
    profiles, and a vocabulary without b"\\xff"; and a profile engine
    forced onto the piece path."""
    ranks, specials = make_tiny_vocab()
    no_ff = {b: r for b, r in ranks.items() if b != b"\xff"}
    return {"pattern": (r"\w+|\s+|[^\w\s]+", ranks, specials, None),
            "byte_rank": (LLAMA4_PATTERN, no_ff, specials, None),
            "stream_false": (LLAMA4_PATTERN, ranks, specials, False)}


@pytest.mark.parametrize("kind", ["pattern", "byte_rank", "stream_false"])
def test_piece_path_equals_host_and_tiktoken(kind):
    import tiktoken

    pat, ranks, specials, stream = _piece_tokenizers()[kind]
    port = DeviceEngine(pat, ranks, specials, device="cpu", stream=stream)
    assert port.stream is False
    host = HostEngine(pat, ranks, specials)
    tk = tiktoken.Encoding("t", pat_str=pat, mergeable_ranks=ranks,
                           special_tokens=specials)
    rng = np.random.default_rng(8)
    texts = [multiscript_text(rng, 20000) + "<|bos|>" + prose_text(rng, 9000),
             "", "hello <|eos|>", prose_text(rng, 300)]
    allowed = set(specials)
    got = port.encode_batch(texts, allowed)
    assert got == [host.encode(t, allowed)[0] for t in texts]
    assert got == [tk.encode(t, allowed_special="all") for t in texts]
    assert port.encode_ordinary_batch(texts[:1]) == [
        tk.encode_ordinary(texts[0])]
    assert sum(port.stats.merge_rows_by_width.values()) > 0
    with pytest.raises(ValueError, match="piece path"):
        port.encode_stream(b"hello")


def test_stream_needs_a_profile():
    ranks, specials = make_tiny_vocab()
    with pytest.raises(ValueError, match="profiles"):
        DeviceEngine(r"\w+|\s+", ranks, specials, device="cpu", stream=True)
    eng = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu")
    assert eng.stream and eng._merge is None   # merge tables: on first use


@pytest.mark.parametrize("join", ["probe", "sort"])
@pytest.mark.parametrize("miss", ["host", "device"])
def test_window_modes_equal_host(miss, join):
    """The stream path under each miss_mode and join_mode (resolve_window
    where either is not the default) gives the host engine's ids, windows
    cut at safe offsets; "device" splices only pieces over 256 bytes."""
    from torch_port_util import merge_vocab

    ranks, specials = merge_vocab()
    port = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu")
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    port.miss_mode, port.join_mode = miss, join
    rng = np.random.default_rng(9)
    text = (prose_text(rng, 60000) + multiscript_text(rng, 3000) + " "
            + "q" * 300 + " " + prose_text(rng, 70000))
    assert port.encode_stream(text.encode()).tolist() == (
        host.encode_ordinary(text))
    assert port.stats.cut_windows >= 1
    assert port.stats.host_advance_windows == 0
    if miss == "device":
        assert port.stats.spliced_pieces == 1          # the 301-byte piece
        assert port._merge is not None


@pytest.mark.parametrize("miss,join", [("device", "probe"),
                                       ("host", "sort"), ("device", "sort")])
def test_window_modes_batch_complete_segments(miss, join):
    """Complete segments under a non-default miss_mode or join_mode run
    as one batch of windows through resolve_window (the same executor as
    the default modes) and give the host engine's ids; "device" counts
    each merge width's rows over the whole batch."""
    from torch_port_util import merge_vocab

    ranks, specials = merge_vocab()
    port = DeviceEngine(LLAMA4_PATTERN, ranks, specials, device="cpu")
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    port.miss_mode, port.join_mode = miss, join
    rng = np.random.default_rng(19)
    segs = [prose_text(rng, 20000), multiscript_text(rng, 9000),
            prose_text(rng, 5000) + " " + "q" * 300 + " end",
            multiscript_text(rng, 12000)]
    got = port.encode_streams([s.encode() for s in segs])
    assert [g.tolist() for g in got] == [host.encode_ordinary(s)
                                         for s in segs]
    st = port.stats
    assert (st.windows, st.window_batches) == (4, 1)
    assert st.host_advance_windows == st.cut_windows == 0
    if miss == "device":
        assert st.spliced_pieces == 1          # the 301-byte piece
        assert sum(st.merge_rows_by_width.values()) > 0
    else:
        assert st.spliced_pieces > 1 and not st.merge_rows_by_width


def test_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    ranks, specials = make_tiny_vocab()
    with pytest.raises(RuntimeError):
        DeviceEngine(LLAMA4_PATTERN, ranks, specials)
