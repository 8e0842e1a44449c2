"""The port's distribution layer (``tokendagger_tpu_torch/parallel``) on
gloo over the CPU, held against the JAX package's ``parallel/`` on the
virtual CPU devices of conftest at the same mesh size and inputs:

* ``shard_merge_rows``, ``sharded_encode_step`` (D = 1 in this process,
  D = 2 and 4 in four spawned ranks) and ``sharded_encode_step_2d`` at
  (2, 2): tok, counts and both counters exactly equal (the rows of
  tests/test_parallel.py);
* ``ShardedTextEncoder`` at D = 1 and D = 4, 2,048-byte shards and a
  512-byte halo, on every case of tests/test_sharded_text.py and two
  texts in each of the four profiles: ids, ``passes`` and ``fallbacks``
  equal to the JAX encoder's, ids equal to ``HostEngine``'s; one pass's
  per-shard outputs at D = 1 field by field.

The spawned ranks import torch and the port only
(tests/torch_mesh_workers.py): one spawn of four runs every D = 2 and
D = 4 case."""

import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_workers
from tests.conftest import make_tiny_vocab
from tokendagger_tpu import vocab as JV
from tokendagger_tpu.engine import DeviceEngine as JaxEngine
from tokendagger_tpu.parallel import mesh as JM
from tokendagger_tpu.parallel.sharded_text import (
    ShardedTextEncoder as JaxSharded,
)
from tokendagger_tpu.tables import build_tables
from tokendagger_tpu_torch import DeviceEngine, HostEngine
from tokendagger_tpu_torch.convert import merge_tables_from_ranks
from tokendagger_tpu_torch.parallel import mesh as PM
from tokendagger_tpu_torch.parallel.sharded_text import ShardedTextEncoder
from torch_port_util import multiscript_text, prose_text

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import make_corpus  # noqa: E402

PATTERNS = {"llama4": JV.LLAMA4_PATTERN, "nocontract": JV.TEKKEN_PATTERN,
            "cl100k": JV.CL100K_PATTERN, "gpt2": JV.GPT2_PATTERN}


def _halo_vocab():
    ranks = {bytes([i]): i for i in range(256)}
    ranks[b"\n "] = 256
    ranks[b"  "] = 257
    ranks[b" \n"] = 258
    return ranks


VOCABS = {"tiny": make_tiny_vocab()[0], "halo": _halo_vocab()}


def _profile_texts(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [prose_text(rng, 9000), multiscript_text(rng, 9000)]


# (name, profile, vocab, texts): the cases of tests/test_sharded_text.py,
# then two texts in each profile
CASES = [
    ("english", "llama4", "tiny",
     [make_corpus(14000, seed=s) for s in (5, 9, 13)]),
    ("word_straddles", "llama4", "tiny",
     [("w" * 100 + " ").join(str(i) for i in range(400))]),
    ("multibyte_straddles", "llama4", "tiny", ["日本語のテキストです。" * 800]),
    ("short", "llama4", "tiny", ["hello world", ""]),
    ("overflow", "llama4", "tiny",
     ["start " + "=" * 500 + " end " + "hello " * 2000]),
    ("multi_pass", "llama4", "tiny", ["the and is " * 3000]),
    ("multi_pass_large", "llama4", "tiny", [make_corpus(100_000, seed=4)]),
    ("multi_pass_cjk", "llama4", "tiny", ["日本語のテキストです。" * 4000]),
    ("oversize_splice", "llama4", "tiny",
     ["hello " * 300 + "=" * 500 + " mid " + "#" * 200 + " "
      + "world " * 1500]),
    ("halo_guard", "llama4", "halo",
     ["a" * 2000 + "\n" + " " * gap + "\n" + "b" * 4000
      for gap in (300, 600, 900)]),
] + [(f"profile_{p}", p, "tiny", _profile_texts(i))
     for i, p in enumerate(PATTERNS)]
CASE_NAMES = [c[0] for c in CASES]


def _rows():
    """The packed rows of tests/test_parallel.py."""
    words = [b"hello", b"the and", b"to the store", b"is it", b"ar", b"x",
             b"hellohello", b"and and and"]
    R, C = 64, 32
    buf = np.zeros((R, C), dtype=np.uint8)
    lens = np.zeros(R, dtype=np.int32)
    for r in range(R):
        w = words[r % len(words)]
        buf[r, : len(w)] = np.frombuffer(w, dtype=np.uint8)
        lens[r] = len(w)
    return buf, lens


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The encoder's passes are thousands of small ops: with the test
    workers sharing the cores, torch's intra-op threads made one pass
    ~150x slower, so this module runs torch on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every D = 2 and D = 4 case in one spawn of four gloo ranks."""
    buf, lens = _rows()
    cases = [(PATTERNS[p], VOCABS[v], [t.encode() for t in texts])
             for _, p, v, texts in CASES]
    return torch_mesh_workers.spawn(
        4, tmp_path_factory.mktemp("world4"), "parallel",
        ranks=VOCABS["tiny"], buf=buf, lens=lens, cases=cases)


# ---------------------------------------------------------------------------
# merge steps
# ---------------------------------------------------------------------------


def _jax_steps(D: int):
    """JAX shard_merge_rows and sharded_encode_step over get_mesh(D)."""
    buf, lens = _rows()
    t = build_tables(VOCABS["tiny"], {}, use_cache=False)
    mesh = JM.get_mesh(D)
    bb, ln = JM.shard_rows(mesh, jnp.asarray(buf), jnp.asarray(lens))
    args = (bb, ln, jnp.asarray(t.byte_rank), jnp.asarray(t.pair.rows))
    merged = JM.shard_merge_rows(mesh)(*args, mask=t.pair.mask)
    step = JM.sharded_encode_step(mesh)(*args, mask=t.pair.mask)
    return [np.asarray(x) for x in merged], [np.asarray(x) for x in step]


def _assert_step(blocks, want):
    """Per-rank (tok, counts, bytes, tokens) blocks against the JAX
    step's global outputs: blocks concatenate to tok and counts, and
    every rank holds both counters."""
    assert np.array_equal(np.concatenate([b[0] for b in blocks]), want[0])
    assert np.array_equal(np.concatenate([b[1] for b in blocks]), want[1])
    for b in blocks:
        assert int(b[2]) == int(want[2]) and int(b[3]) == int(want[3])


def test_steps_in_process_equal_jax():
    mesh = PM.get_mesh(1, device="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    buf, lens = _rows()
    mt = merge_tables_from_ranks(VOCABS["tiny"], device="cpu")
    bb, ln = PM.shard_rows(mesh, buf, lens)
    args = (bb, ln, mt.byte_rank, mt.pair_rows, mt.pair_mask)
    merged = [x.numpy() for x in PM.shard_merge_rows(mesh)(*args)]
    step = [x.numpy() for x in PM.sharded_encode_step(mesh)(*args)]
    want_merged, want_step = _jax_steps(1)
    assert all(np.array_equal(a, b) for a, b in zip(merged, want_merged))
    _assert_step([step], want_step)
    assert int(step[2]) == int(lens.sum())


@pytest.mark.parametrize("D", [2, 4])
def test_steps_equal_jax(world4, D):
    key = f"steps{D}"
    want_merged, want_step = _jax_steps(D)
    blocks = [r[key]["step"] for r in world4[:D]]
    _assert_step(blocks, want_step)
    merged = [r[key]["merge"] for r in world4[:D]]
    for j in range(2):
        assert np.array_equal(np.concatenate([m[j] for m in merged]),
                              want_merged[j])
    assert all("step" not in r[key] for r in world4[D:])  # outside the mesh


def test_step_2d_equals_jax(world4):
    from jax.sharding import NamedSharding, PartitionSpec as P

    buf, lens = _rows()
    t = build_tables(VOCABS["tiny"], {}, use_cache=False)
    mesh = JM.get_mesh_2d(2, 2)
    bb = jax.device_put(jnp.asarray(buf),
                        NamedSharding(mesh, P(("hosts", "chips"), None)))
    ln = jax.device_put(jnp.asarray(lens),
                        NamedSharding(mesh, P(("hosts", "chips"))))
    want = [np.asarray(x) for x in JM.sharded_encode_step_2d(mesh)(
        bb, ln, jnp.asarray(t.byte_rank), jnp.asarray(t.pair.rows),
        mask=t.pair.mask)]
    _assert_step([r["steps4"]["2d"] for r in world4], want)


def test_mesh_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PM.get_mesh(1)


def test_step_2d_refuses_a_1d_mesh():
    with pytest.raises(ValueError):
        PM.sharded_encode_step_2d(PM.get_mesh(1, device="cpu"))


# ---------------------------------------------------------------------------
# ShardedTextEncoder
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _jax_encoder(D: int, profile: str, vocab: str):
    eng = JaxEngine(PATTERNS[profile], VOCABS[vocab], {})
    return JaxSharded(eng, JM.get_mesh(D), shard_bytes=2048, halo=512)


@lru_cache(maxsize=None)
def _port_encoder(profile: str, vocab: str):
    eng = DeviceEngine(PATTERNS[profile], VOCABS[vocab], {}, device="cpu")
    return ShardedTextEncoder(eng, PM.get_mesh(1, device="cpu"),
                              shard_bytes=2048, halo=512)


def _encode_counted(st, data: bytes):
    p0, f0 = st.passes, st.fallbacks
    ids = st.encode(data)
    return np.asarray(ids).tolist(), st.passes - p0, st.fallbacks - f0


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("case", CASE_NAMES)
def test_sharded_text_equals_jax_and_host(world4, case, D):
    i = CASE_NAMES.index(case)
    _, profile, vocab, texts = CASES[i]
    host = HostEngine(PATTERNS[profile], VOCABS[vocab], {})
    jst = _jax_encoder(D, profile, vocab)
    for j, text in enumerate(texts):
        data = text.encode()
        want = _encode_counted(jst, data)
        if D == 1:
            got = _encode_counted(_port_encoder(profile, vocab), data)
        else:
            per_rank = [r["text4"][i][j] for r in world4]
            got = (per_rank[0][0].tolist(), *per_rank[0][1:])
            for ids, passes, fallbacks in per_rank[1:]:
                assert (ids.tolist(), passes, fallbacks) == got
        assert got == want, (case, j, got[1:], want[1:])
        assert got[0] == host.encode_ordinary(text), (case, j)


@pytest.mark.parametrize("route", ["native", "python"])
def test_sharded_text_splices_many_oversize_pieces(route):
    """Words of up to 200 random letters, a third of them over the
    sharded body's 64-byte merge rows: ShardedTextEncoder splices them
    with its engine's ``Splicer`` (shard spans offset by the shard's
    base), on the native route and on the Python loop, to the host
    engine's ids, without falling back."""
    ranks = VOCABS["tiny"]
    eng = DeviceEngine(PATTERNS["llama4"], ranks, {}, device="cpu")
    st = ShardedTextEncoder(eng, PM.get_mesh(1, device="cpu"),
                            shard_bytes=2048, halo=512)
    if route == "python":
        eng._splicer.native = None
    elif eng._splicer.native is None:
        pytest.skip("no C++ toolchain for tdnative.cpp")
    rng = np.random.default_rng(14)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    text = "".join(" " + rng.choice(letters, int(k)).tobytes().decode()
                   for k in rng.integers(2, 200, 120))
    data = text.encode()
    wide = st.pass_outputs(data[:2048], final=len(data) <= 2048)["n_wide"]
    assert wide[0] >= 5
    got, passes, fallbacks = _encode_counted(st, data)
    assert got == HostEngine(PATTERNS["llama4"], ranks, {}).encode_ordinary(
        text)
    assert passes >= 2 and fallbacks == 0
    assert (eng._splicer.native is not None) == (route == "native")


def _jax_pass(st, data: bytes, final: bool):
    """The JAX encoder's per-shard outputs of one pass: the inputs as its
    ``_one_pass`` builds them."""
    D, W, H = st.D, st.W, st.H
    n = len(data)
    buf = np.zeros((D, W + H), dtype=np.uint8)
    nloc = np.zeros(D, dtype=np.int32)
    for d in range(D):
        lo = d * W
        if lo < n:
            chunk = np.frombuffer(data[lo : min(n, lo + W + H)], np.uint8)
            buf[d, : len(chunk)] = chunk
            nloc[d] = len(chunk)
    last = min((n - 1) // W, D - 1)
    true_eos = np.zeros(D, dtype=bool)
    trim = np.full(D, 1 << 30, dtype=np.int32)
    if final:
        true_eos = (nloc > 0) & (np.arange(D) * W + nloc == n)
    else:
        trim[last] = st.eng._safe_cut_threshold(bytes(buf[last, : nloc[last]]))
    eng = st.eng
    out = st._fn(jnp.asarray(buf), jnp.asarray(nloc), jnp.asarray(true_eos),
                 jnp.asarray(trim), jnp.asarray(np.arange(D, dtype=np.int32)),
                 eng._page_ids, eng._pages, eng._byte_rank, eng._pair_rows)
    keys = ("flat", "total", "overflow", "consumed_end", "os_start",
            "os_len", "n_wide", "total_bytes")
    return {k: np.asarray(v) for k, v in zip(keys, out)}


@pytest.mark.parametrize("final", [False, True])
def test_pass_outputs_equal_jax(final):
    """One pass at D = 1, field by field: a continuing pass (trimmed at
    its safe cut) over English, and a final one with oversize pieces."""
    text = (make_corpus(4000, seed=5) if not final else
            "hello " * 100 + "=" * 300 + " mid " + "#" * 90 + " x")
    data = text.encode()[:2048]
    want = _jax_pass(_jax_encoder(1, "llama4", "tiny"), data, final)
    got = _port_encoder("llama4", "tiny").pass_outputs(data, final)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]).reshape(want[k].shape),
                              want[k]), k
    assert want["n_wide"][0] == (2 if final else 0)
    assert want["total"][0] > 0 and not want["overflow"][0]
