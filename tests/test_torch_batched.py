"""The port's batched short-segment path (ops/batched.resolve_grid and
DeviceEngine.encode_streams' grids) on the CPU, held against the JAX
package's resolve_grid and encode_streams and the host engine: exact
equality of every output. Also the locks that let several threads encode
through one engine."""

import sys
import threading

import numpy as np
import pytest
import torch

from tests.conftest import make_tiny_vocab
from tokendagger_tpu.engine import DeviceEngine as JaxEngine
from tokendagger_tpu.ops.batched import resolve_grid as jax_resolve_grid
from tokendagger_tpu_torch import (
    LLAMA4_PATTERN, DeviceEngine, HostEngine, Tokenizer,
)
from tokendagger_tpu_torch.ops import batched as TBat
from tokendagger_tpu_torch.ops import compact as CP
from tokendagger_tpu_torch.ops.fused import SENTINEL
from tokendagger_tpu_torch.vocab import (
    CL100K_PATTERN, GPT2_PATTERN, TEKKEN_PATTERN,
)
from torch_port_util import collision_vocab, multiscript_text, prose_text

# each profile with one of the two in-repo vocabularies
PROFILE_CASES = [("llama4", LLAMA4_PATTERN, "tiny"),
                 ("nocontract", TEKKEN_PATTERN, "collision"),
                 ("cl100k", CL100K_PATTERN, "tiny"),
                 ("gpt2", GPT2_PATTERN, "collision")]


def _vocab(kind):
    if kind == "tiny":
        return make_tiny_vocab()
    ranks, _crowd = collision_vocab()
    return ranks, {"<|bos|>": len(ranks), "<|eot|>": len(ranks) + 1}


_ENGINES: dict = {}


def _engines(pattern, kind):
    """(port engine on the CPU, JAX engine, host engine), built once."""
    key = (pattern, kind)
    if key not in _ENGINES:
        ranks, specials = _vocab(kind)
        _ENGINES[key] = (
            DeviceEngine(pattern, ranks, specials, device="cpu"),
            JaxEngine(pattern, ranks, specials),
            HostEngine(pattern, ranks, specials))
    return _ENGINES[key]


def _cut(raw: bytes, n: int) -> bytes:
    """The longest prefix of ``raw`` of at most n bytes that ends at a
    char boundary."""
    return raw[:n].decode("utf-8", errors="ignore").encode()


def _grid_rows(W: int, seed: int) -> list[bytes]:
    """Rows for a grid of width W: ragged multi-script text, an empty row,
    a row of exactly W bytes, a row of vocabulary misses, oversize pieces
    (letter, digit and space runs longer than 16 bytes), dense ASCII, and
    a row of one piece."""
    rng = np.random.default_rng(seed)
    misses = ("日本語 中文文本 テキスト ")
    oversize = ("a" * 40 + " " + "Z" * 100 + " " * 50 + "7" * 30 + "!" * 24
                + " ")
    return [
        _cut(multiscript_text(rng, W).encode(), W - 13),
        b"",
        prose_text(rng, W).encode()[:W],
        _cut((misses * W).encode(), W),
        _cut((oversize * (W // len(oversize) + 1)).encode(), W),
        _cut("it's  WON'T I'll 123,456 a//b \r\n\t  Zz0 ".encode() * 100, W),
        b"x" * W,
    ]


def _stage_grid(rows, W):
    buf = np.zeros((len(rows), W), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for r, s in enumerate(rows):
        buf[r, : len(s)] = np.frombuffer(s, np.uint8)
        lens[r] = len(s)
    return buf, lens


@pytest.mark.parametrize("W", list(TBat.ROW_WIDTHS))
@pytest.mark.parametrize("profile,pattern,kind", PROFILE_CASES)
def test_resolve_grid_equals_jax(profile, pattern, kind, W):
    """Every output of the port's resolve_grid equals the JAX function's
    on each row's valid prefix (exact equality), and the spliced rows
    equal the host engine."""
    port, jax_engine, host = _engines(pattern, kind)
    assert port._profile == profile
    rows = _grid_rows(W, W + len(profile))
    buf, lens = _stage_grid(rows, W)
    want = jax_resolve_grid(
        buf, lens, page_ids=jax_engine._page_ids, pages=jax_engine._pages,
        vhash_rows=jax_engine._vhash_rows,
        vhash_mask=jax_engine.tables.vhash8_mask,
        contractions=jax_engine._contractions, profile=jax_engine._profile)
    got = TBat.resolve_grid(buf, lens, vhash_rows=port.tables.vhash8_rows,
                            vhash_mask=port.tables.vhash8_mask,
                            profile=profile)
    flat, total, ms_s, ms_l, n_ms = got
    assert np.array_equal(total, want[1])
    assert np.array_equal(n_ms, want[4])
    assert flat.shape == want[0].shape
    assert n_ms[3] == total[3] > 0          # the row of misses
    assert (flat == SENTINEL).sum() == n_ms.sum()
    for r, s in enumerate(rows):
        k = int(n_ms[r])
        assert np.array_equal(flat[r, : total[r]], want[0][r, : total[r]]), r
        assert np.array_equal(ms_s[r, :k], want[2][r, :k]), r
        assert np.array_equal(ms_l[r, :k], want[3][r, :k]), r
        ids = flat[r, : total[r]].astype(np.int64)
        if k:
            ids = port._splice_oversize(ids, s, ms_s[r], ms_l[r], k)
        assert ids.tolist() == host.encode_ordinary(s.decode()), r


def test_grid_rows_and_widths_equal_jax():
    from tokendagger_tpu.ops import batched as JBat

    assert TBat.ROW_WIDTHS == JBat.ROW_WIDTHS
    assert TBat.MAX_GRID_BYTES == JBat.MAX_GRID_BYTES
    for w in (1, 256, 1024, 4096, 1 << 21):
        assert TBat.grid_rows(w) == JBat.grid_rows(w)


def _segments(seed: int, n: int) -> list[bytes]:
    """n segments: multi-script texts of 0-5000 bytes (so some take the
    stream route), empties, and rows at the width edges."""
    rng = np.random.default_rng(seed)
    segs = [_cut(multiscript_text(rng, int(k)).encode(), int(k))
            for k in rng.integers(0, 5000, n)]
    segs[:8] = [b"", b"x" * 256, b"y" * 257, b"z" * 4096, b"w" * 4097,
                "é".encode() * 128, b" " * 300, b"don't 42"]
    return segs


@pytest.mark.parametrize("n", [40, 3])
def test_encode_streams_equals_jax_and_host(n):
    """With four or more short segments they go through grids; with fewer
    every segment takes the stream route. Either way the ids equal the JAX
    engine's and the host engine's."""
    port, jax_engine, host = _engines(LLAMA4_PATTERN, "tiny")
    segs = _segments(n, n)
    before = port.stats.grids
    got = port.encode_streams(segs)
    want = jax_engine.encode_streams(segs)
    assert len(got) == len(want) == len(segs)
    for g, w, s in zip(got, want, segs):
        assert g.dtype == np.int64
        assert g.tolist() == w.tolist() == host.encode_ordinary(s.decode())
    short = [s for s in segs if 0 < len(s) <= TBat.ROW_WIDTHS[-1]]
    if len(short) >= 4:
        assert port.stats.grids > before
    else:
        assert port.stats.grids == before


@pytest.mark.parametrize("profile,pattern,kind", PROFILE_CASES,
                         ids=[c[0] for c in PROFILE_CASES])
def test_complete_segments_share_batched_windows(profile, pattern, kind):
    """Segments that each fit one window run as (B, N) batches of windows,
    the longest first, at most BATCH_WINDOWS a batch; one whose window
    overflows its piece slots takes encode_stream (and there the exact
    host route), one longer than a window is cut as before. The ids equal
    the host engine's, and under llama4 the JAX engine's."""
    from tokendagger_tpu_torch import engine as TE

    port, jax_engine, host = _engines(pattern, kind)
    rng = np.random.default_rng(11)
    segs = [_cut(multiscript_text(rng, int(k)).encode(), int(k))
            for k in rng.integers(4097, 40000, 10)]
    segs += [b"1!" * 15000, b"", b"tail", _cut(
        multiscript_text(rng, 90000).encode(), 90000)]
    before = TE.EngineStats(**vars(port.stats))
    got = port.encode_streams(segs)
    for g, s in zip(got, segs):
        assert g.tolist() == host.encode_ordinary(s.decode())
    if profile == "llama4":
        want = jax_engine.encode_streams(segs)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    st = port.stats
    # 10 + "1!"... + "tail" batched as 8 + 4; every later window (the
    # overflow once more, the long segment's cuts) a batch of its own
    assert ((st.windows - before.windows)
            - (st.window_batches - before.window_batches)) == 12 - 2
    assert st.host_advance_windows > before.host_advance_windows
    assert st.cut_windows > before.cut_windows


def test_encode_batch_splits_specials_into_grids():
    """encode_batch over many short texts with specials: the spans between
    specials go through grids, and the ids equal the host engine's."""
    ranks, specials = make_tiny_vocab()
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, device="cpu")
    rng = np.random.default_rng(4)
    sp = sorted(specials)
    texts = [multiscript_text(rng, int(k)) for k in rng.integers(0, 900, 30)]
    texts = [t + sp[i % len(sp)] + t[: i * 7] if i % 3 == 0 else t
             for i, t in enumerate(texts)]
    got = tok.encode_batch(texts, allowed_special="all")
    host = HostEngine(LLAMA4_PATTERN, ranks, specials)
    for g, t in zip(got, texts):
        assert g == host.encode(t, set(specials))[0]
    st = tok._get_device().stats
    assert st.grids >= 1 and st.grid_rows >= 30 and st.windows == 0


def test_threads_share_one_tokenizer():
    """Four threads encode through one Tokenizer (device engine on the
    CPU, grids and windows) and each gets the serial ids."""
    ranks, specials = make_tiny_vocab()
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, device="cpu")
    rng = np.random.default_rng(12)
    jobs = [[multiscript_text(rng, int(k)) for k in rng.integers(0, 3000, 12)]
            for _ in range(8)]
    jobs.append([multiscript_text(rng, 70000)])       # stream windows
    serial = [tok.encode_batch(j, allowed_special="all") for j in jobs]
    got = [None] * len(jobs)
    errors = []

    def work(t):
        try:
            for i in range(t, len(jobs), 4):
                got[i] = tok.encode_batch(jobs[i], allowed_special="all")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert got == serial


def test_status_epochs_are_unique_under_threads():
    """The look-back kernels' epoch bump is atomic: 16 threads drawing
    epochs for one key never get the same one."""
    key = ("test", torch.device("cpu"), 0)
    seen: list[list[int]] = [[] for _ in range(16)]

    def draw(t):
        for _ in range(500):
            seen[t].append(CP._status(key, 64)[1])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=draw, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        CP._STATUS.pop(key, None)
    assert not any(th.is_alive() for th in threads)
    epochs = [e for s in seen for e in s]
    assert len(epochs) == len(set(epochs)) == 16 * 500
