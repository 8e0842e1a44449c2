"""Port of ops/join (key words, bucket hash, vhash8 probe) held equal to
the JAX package's vocab_probe8t_chunks and its numpy reference, including
the bucket-overflow entries the table drops."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokendagger_tpu import tables as JT
from tokendagger_tpu.ops import join as JJ
from tokendagger_tpu.ops import merge as JM
from tokendagger_tpu_torch.ops import join as TJ
from tokendagger_tpu_torch.ops import merge as TM
from torch_port_util import collision_vocab


@pytest.fixture(scope="module")
def table():
    ranks, crowd = collision_vocab(seed=1)
    return ranks, crowd, JT.build_tables(ranks, {}, use_cache=False)


def _queries(ranks, crowd, seed):
    """Key words/lengths of vocab tokens (hits), the crowded bucket's
    tokens (some dropped), non-tokens and dead slots."""
    rng = np.random.default_rng(seed)
    toks = list(ranks)
    pieces = [toks[int(i)] for i in rng.integers(len(toks), size=300)]
    pieces += crowd
    pieces += [bytes(rng.integers(32, 127, int(rng.integers(1, 24))))
               for _ in range(200)]
    pieces += [b""] * 20
    qk = np.zeros((len(pieces), 4), np.uint32)
    ql = np.zeros(len(pieces), np.int32)
    for i, p in enumerate(pieces):
        buf = np.zeros(16, np.uint8)
        buf[: min(16, len(p))] = np.frombuffer(p[:16], np.uint8)
        qk[i] = buf.view("<u4")
        ql[i] = len(p)
    return qk, ql


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_equals_jax(table, seed):
    ranks, crowd, t = table
    qk, ql = _queries(ranks, crowd, seed)
    want_np = JJ.vocab_probe8_np(qk, ql, t.vhash8_rows, t.vhash8_mask)
    want = np.asarray(JJ.vocab_probe8t_chunks(
        *(jnp.asarray(qk[:, j]) for j in range(4)), jnp.asarray(ql),
        jnp.asarray(t.vhash8_rows), t.vhash8_mask, n_chunks=3))
    qi = qk.view(np.int32)
    got = TJ.vocab_probe8(
        *(torch.from_numpy(qi[:, j].copy()) for j in range(4)),
        torch.from_numpy(ql), torch.from_numpy(t.vhash8_rows),
        t.vhash8_mask).numpy()
    assert np.array_equal(want, got)
    assert np.array_equal(want_np, got)
    # the crowded bucket's dropped tokens are deliberate misses
    crowd_ranks = got[300 : 300 + len(crowd)]
    assert (crowd_ranks == -1).sum() == len(crowd) - 8
    assert t.vhash8_dropped >= len(crowd) - 8
    assert (got[-20:] == -1).all()


def test_probe_batched_shape(table):
    ranks, crowd, t = table
    qk, ql = _queries(ranks, crowd, 2)
    n = (len(ql) // 2) * 2
    qi = qk.view(np.int32)[:n].reshape(2, n // 2, 4)
    got = TJ.vocab_probe8(
        *(torch.from_numpy(qi[..., j].copy()) for j in range(4)),
        torch.from_numpy(ql[:n].reshape(2, -1)),
        torch.from_numpy(t.vhash8_rows), t.vhash8_mask).numpy()
    want = JJ.vocab_probe8_np(qk[:n], ql[:n], t.vhash8_rows, t.vhash8_mask)
    assert np.array_equal(want.reshape(2, -1), got)


def test_vhash_and_mix_equal_jax():
    rng = np.random.default_rng(4)
    k = rng.integers(0, 2**32, (4, 3000), dtype=np.uint64).astype(np.uint32)
    ln = rng.integers(0, 17, 3000).astype(np.int32)
    wa, wb = JT._vhash_ab(k[0], k[1], k[2], k[3], ln)
    ta, tb = TJ.vhash_ab(*(torch.from_numpy(x.view(np.int32)) for x in k),
                         torch.from_numpy(ln))
    assert np.array_equal(wa.view(np.uint32), ta.numpy())
    assert np.array_equal(wb.view(np.uint32), tb.numpy())
    for which in (0, 1):
        want = np.asarray(JM._mix(jnp.asarray(wa), jnp.asarray(wb), which,
                                  0x3FFFF))
        got = TM._mix(torch.from_numpy(wa), torch.from_numpy(wb), which,
                      0x3FFFF).numpy()
        assert np.array_equal(want, got)


@pytest.mark.parametrize("nbytes", [0, 1, 5, 4093, 4096])
def test_sliding_words_equal_jax(nbytes):
    rng = np.random.default_rng(nbytes)
    data = rng.integers(0, 256, 4096).astype(np.uint8)
    want = JJ.sliding_words(jnp.asarray(data), jnp.int32(nbytes))
    got = TJ.sliding_words(torch.from_numpy(data), torch.tensor(nbytes))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).astype(np.int64), g.numpy())
    w0 = JJ.sliding_word0(jnp.asarray(data), jnp.int32(nbytes))
    g0 = TJ.sliding_word0(torch.from_numpy(data), torch.tensor(nbytes))
    assert np.array_equal(np.asarray(w0).astype(np.int64), g0.numpy())


def _key_arrays(pieces, B):
    """(B, P) uint32 key words and int32 lengths of ``pieces`` laid out
    row by row."""
    qk = np.zeros((len(pieces), 4), np.uint32)
    ql = np.zeros(len(pieces), np.int32)
    for i, p in enumerate(pieces):
        buf = np.zeros(16, np.uint8)
        buf[: min(16, len(p))] = np.frombuffer(p[:16], np.uint8)
        qk[i] = buf.view("<u4")
        ql[i] = len(p)
    return qk.reshape(B, -1, 4), ql.reshape(B, -1)


def test_piece_key_words_equal_jax():
    for p in (b"", b"a", b" the", b"caf\xc3\xa9", b"x" * 16, b"y" * 23,
              b"\xff" * 5):
        assert TJ.piece_key_words(p) == JJ.piece_key_words(p)


def test_vocab_probe_hot_equals_jax():
    """Hot pieces answered by compare (one outside the vocabulary, rank
    -1; one whose first key word is >= 2**31), the rest probed on the
    compacted prefix and put back; dead slots -1; overflow flags."""
    ranks, crowd = collision_vocab(seed=2)
    ranks = dict(ranks)
    cafe, outside = b"caf\xc3\xa9", b"zq!zq!zq"
    ranks[cafe] = len(ranks)
    t = JT.build_tables(ranks, {}, use_cache=False)
    rng = np.random.default_rng(12)
    toks = [k for k in ranks if len(k) > 1]
    hot = [toks[int(i)] for i in rng.choice(len(toks), 30, replace=False)]
    hot += [cafe, outside]
    assert outside not in ranks
    assert TJ.piece_key_words(cafe)[0] >= 2**31
    B, P = 2, 1 << 15
    pieces = []
    for b, live in enumerate((P - 3000, P // 2)):
        for _ in range(live):
            r = rng.random()
            if r < 0.45:
                pieces.append(hot[int(rng.integers(len(hot)))])
            elif r < 0.8:
                pieces.append(toks[int(rng.integers(len(toks)))])
            elif r < 0.9:
                pieces.append(crowd[int(rng.integers(len(crowd)))])
            else:
                pieces.append(bytes(rng.integers(32, 256,
                                                 int(rng.integers(1, 24)))
                                    .astype(np.uint8)))
        pieces += [b""] * (P - live)
    qk, ql = _key_arrays(pieces, B)
    hot_keys = tuple(JJ.piece_key_words(p) for p in hot)
    hot_ranks = tuple(ranks.get(p, -1) for p in hot)
    qi = qk.view(np.int32)
    for u_cap in (4096, 16384):
        want, want_ovf = JJ.vocab_probe_hot(
            *(jnp.asarray(qk[..., j]) for j in range(4)), jnp.asarray(ql),
            jnp.asarray(t.vhash8_rows), t.vhash8_mask, hot_keys=hot_keys,
            hot_ranks=hot_ranks, u_cap=u_cap, n_chunks=4, interpret=True)
        got, ovf = TJ.vocab_probe_hot(
            *(torch.from_numpy(qi[..., j].copy()) for j in range(4)),
            torch.from_numpy(ql), torch.from_numpy(t.vhash8_rows),
            t.vhash8_mask, hot_keys=hot_keys, hot_ranks=hot_ranks,
            u_cap=u_cap)
        assert np.array_equal(np.asarray(want_ovf), ovf.numpy())
        if u_cap == 4096:
            assert ovf.all()
            continue
        assert not ovf.any()
        assert np.array_equal(np.asarray(want), got.numpy())
    # the cafe and outside slots took their hot ranks
    g = got.numpy().reshape(-1)
    at = [i for i, p in enumerate(pieces) if p == cafe]
    assert at and (g[at] == ranks[cafe]).all()
    at = [i for i, p in enumerate(pieces) if p == outside]
    assert at and (g[at] == -1).all()
    # the probed (non-hot) slots equal the plain probe
    plain = TJ.vocab_probe8(
        *(torch.from_numpy(qi[..., j].copy()) for j in range(4)),
        torch.from_numpy(ql), torch.from_numpy(t.vhash8_rows),
        t.vhash8_mask).numpy().reshape(-1)
    probed = np.array([p not in hot for p in pieces])
    assert np.array_equal(plain[probed], g[probed])


def test_vocab_probe_hot_colliding_hashes(monkeypatch):
    """Hot keys whose 64-bit hashes collide are compared one by one: force
    every hash equal and the result does not change."""
    ranks, crowd = collision_vocab(seed=4)
    t = JT.build_tables(ranks, {}, use_cache=False)
    pieces = list(ranks)[256:300] * 3 + crowd + [b""] * 4
    qk, ql = _key_arrays(pieces, 1)
    qi = qk.view(np.int32)
    hot = pieces[:10]
    kw = dict(hot_keys=tuple(JJ.piece_key_words(p) for p in hot),
              hot_ranks=tuple(ranks.get(p, -1) for p in hot), u_cap=256)
    args = [torch.from_numpy(qi[..., j].copy()) for j in range(4)]
    args += [torch.from_numpy(ql), torch.from_numpy(t.vhash8_rows),
             t.vhash8_mask]
    want = TJ.vocab_probe_hot(*args, **kw)
    TJ._hot_table.cache_clear()
    monkeypatch.setattr(TJ, "_key_hash",
                        lambda *k: torch.zeros_like(k[0], dtype=torch.int64))
    got = TJ.vocab_probe_hot(*args, **kw)
    TJ._hot_table.cache_clear()
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def _probe_queries(ranks, seed):
    """Key words/lengths of vocab tokens of at most 16 bytes (hits),
    non-tokens (misses), the same words as a hit at another length
    (length-only differences) and dead slots."""
    rng = np.random.default_rng(seed)
    toks = [t for t in ranks if len(t) <= 16]
    hits = [toks[int(i)] for i in rng.integers(len(toks), size=300)]
    pieces = [(p, len(p)) for p in hits]
    pieces += [(rng.integers(32, 127, int(rng.integers(1, 17))).astype(
        np.uint8).tobytes(), None)
               for _ in range(200)]
    pieces += [(p, len(p) + d) for p in hits[:60] for d in (-1, 1)
               if len(p) + d > 0]
    pieces += [(b"", 0)] * 10
    qk = np.zeros((len(pieces), 4), np.uint32)
    ql = np.zeros(len(pieces), np.int32)
    for i, (p, n) in enumerate(pieces):
        buf = np.zeros(16, np.uint8)
        buf[: len(p)] = np.frombuffer(p, np.uint8)
        qk[i] = buf.view("<u4")
        ql[i] = len(p) if n is None else n
    return qk, ql


@pytest.mark.parametrize("seed", [0, 1])
def test_vocab_probe_equals_jax_and_oracles(table, seed):
    """The 4-slot two-gather probe against the JAX ``vocab_probe`` and
    both numpy oracles (the port's copies equal the JAX package's)."""
    from tokendagger_tpu_torch import tables as TT

    ranks, _, t = table
    qk, ql = _probe_queries(ranks, seed)
    rows, mask = TT.build_vocab_hash(*TT.vocab_keys(ranks))
    assert np.array_equal(rows, t.vhash_rows) and mask == t.vhash_mask
    want = np.asarray(JJ.vocab_probe(
        *(jnp.asarray(qk[:, j]) for j in range(4)), jnp.asarray(ql),
        jnp.asarray(t.vhash_rows), t.vhash_mask))
    qi = qk.view(np.int32)
    got = TJ.vocab_probe(
        *(torch.from_numpy(qi[:, j].copy()) for j in range(4)),
        torch.from_numpy(ql), torch.from_numpy(rows), mask).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    oracle = TJ.vocab_probe_np(qk, ql, rows, mask)
    assert np.array_equal(oracle, want)
    assert np.array_equal(oracle, JJ.vocab_probe_np(qk, ql, rows, mask))
    # every token of at most 16 bytes is found: no slot is dropped
    assert (got[:300] >= 0).all()
    expect = np.asarray([ranks.get(bytes(qk[i].view(np.uint8)[: ql[i]]), -1)
                         if ql[i] <= 16
                         and (qk[i].view(np.uint8)[ql[i]:] == 0).all() else -1
                         for i in range(len(ql))])
    assert np.array_equal(got, expect)
    # the 8-slot oracle, against the port's probe and the JAX oracle
    o8 = TJ.vocab_probe8_np(qk, ql, t.vhash8_rows, t.vhash8_mask)
    assert np.array_equal(o8, JJ.vocab_probe8_np(qk, ql, t.vhash8_rows,
                                                 t.vhash8_mask))
    assert np.array_equal(o8, TJ.vocab_probe8(
        *(torch.from_numpy(qi[:, j].copy()) for j in range(4)),
        torch.from_numpy(ql), torch.from_numpy(t.vhash8_rows),
        t.vhash8_mask).numpy())


def test_vocab_probe_takes_uint32_values_in_int64(table):
    from tokendagger_tpu_torch import tables as TT

    ranks, _, _ = table
    qk, ql = _probe_queries(ranks, 2)
    rows, mask = TT.build_vocab_hash(*TT.vocab_keys(ranks))
    as_i32 = TJ.vocab_probe(
        *(torch.from_numpy(qk.view(np.int32)[:, j].copy()) for j in range(4)),
        torch.from_numpy(ql), torch.from_numpy(rows), mask)
    as_i64 = TJ.vocab_probe(
        *(torch.from_numpy(qk[:, j].astype(np.int64)) for j in range(4)),
        torch.from_numpy(ql), torch.from_numpy(rows), mask)
    assert torch.equal(as_i32, as_i64)
