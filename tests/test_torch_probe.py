"""The whole-piece probe kernel's routine (csrc/probe_row.cuh), built for
the host by g++ (csrc/probe_host.cpp) and run piece by piece as the
card's threads run it, held equal bit for bit to the JAX package's
vocab_probe8t_chunks, its numpy oracle and the port's plain version; and
the wrapper's CPU route and input checks."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokendagger_tpu import tables as JT
from tokendagger_tpu.ops import join as JJ
from tokendagger_tpu_torch import tables as TT
from tokendagger_tpu_torch.ops import join as TJ
from torch_port_util import collision_vocab

@pytest.fixture(scope="module")
def table():
    ranks, crowd = collision_vocab(seed=5)
    return ranks, crowd, JT.build_tables(ranks, {}, use_cache=False)


def _keys(pieces):
    """(P, 4) uint32 key words and (P,) int32 lengths of byte pieces."""
    qk = np.zeros((len(pieces), 4), np.uint32)
    ql = np.zeros(len(pieces), np.int32)
    for i, p in enumerate(pieces):
        buf = np.zeros(16, np.uint8)
        buf[: min(16, len(p))] = np.frombuffer(p[:16], np.uint8)
        qk[i] = buf.view("<u4")
        ql[i] = len(p)
    return qk, ql


def _queries(ranks, crowd, seed):
    """Vocabulary tokens (hits), the crowded bucket's tokens (some dropped
    by the table), non-tokens, pieces of 17-40 bytes, the tokens of bytes
    >= 0x80, random words over the whole uint32 range (high bits set),
    and dead slots: length 0 and -1 with zero keys. Returns the keys, the
    lengths and the first 300 pieces (vocabulary tokens)."""
    rng = np.random.default_rng(seed)
    toks = list(ranks)
    pieces = [toks[int(i)] for i in rng.integers(len(toks), size=300)]
    pieces += crowd
    pieces += [bytes(rng.integers(32, 127, int(rng.integers(1, 17)))
                     .astype(np.uint8)) for _ in range(150)]
    pieces += [bytes(rng.integers(0, 256, int(rng.integers(17, 41)))
                     .astype(np.uint8)) for _ in range(60)]
    pieces += [t for t in toks if any(b >= 0x80 for b in t)][:40]
    qk, ql = _keys(pieces)
    wild = rng.integers(0, 2**32, (80, 4), dtype=np.uint64).astype(np.uint32)
    wild[:20, 3] |= 0x80000000
    wl = rng.integers(-1, 41, 80).astype(np.int32)
    dead_k = np.zeros((40, 4), np.uint32)
    dead_l = np.repeat(np.array([0, -1], np.int32), 20)
    return (np.concatenate([qk, wild, dead_k]),
            np.concatenate([ql, wl, dead_l]), pieces[:300])


def _host_probe(qk, ql, rows, mask):
    """td_vocab_probe8_host (csrc/probe_host.cpp) on numpy queries."""
    from tokendagger_tpu_torch._build import host_library

    fn = host_library("probe_host").td_vocab_probe8_host
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_uint,
                   vp]
    fn.restype = None
    words = [np.ascontiguousarray(qk[:, j].view(np.int32)) for j in range(4)]
    ql = np.ascontiguousarray(ql, np.int32)
    rows = np.ascontiguousarray(rows, np.int32)
    out = np.empty(len(ql), np.int32)
    fn(*(w.ctypes.data for w in words), ql.ctypes.data, len(ql),
       rows.ctypes.data, mask, out.ctypes.data)
    return out


def _jax_probe(qk, ql, rows, mask):
    return np.asarray(JJ.vocab_probe8t_chunks(
        *(jnp.asarray(qk[:, j]) for j in range(4)), jnp.asarray(ql),
        jnp.asarray(rows), mask, n_chunks=3))


def _plain(qk, ql, rows, mask):
    qi = qk.view(np.int32)
    return TJ.vocab_probe8_plain(
        *(torch.from_numpy(qi[:, j].copy()) for j in range(4)),
        torch.from_numpy(ql), torch.from_numpy(rows), mask).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_host_build_equals_jax(table, seed):
    ranks, crowd, t = table
    qk, ql, toks = _queries(ranks, crowd, seed)
    rows, mask = t.vhash8_rows, t.vhash8_mask
    got = _host_probe(qk, ql, rows, mask)
    assert np.array_equal(got, _jax_probe(qk, ql, rows, mask))
    assert np.array_equal(got, JJ.vocab_probe8_np(qk, ql, rows, mask))
    assert np.array_equal(got, TJ.vocab_probe8_np(qk, ql, rows, mask))
    assert np.array_equal(got, _plain(qk, ql, rows, mask))
    # the query set reaches every kind of answer: each token its rank, or
    # -1 where the table dropped it from a full bucket
    assert all(g in (-1, ranks[p]) for g, p in zip(got[:300], toks))
    assert 0 < (got[:300] == -1).sum() <= t.vhash8_dropped or (
        got[:300] >= 0).all()
    crowd_got = got[300 : 300 + len(crowd)]
    assert (crowd_got == -1).sum() >= len(crowd) - 8
    assert all(g in (-1, ranks[p]) for g, p in zip(crowd_got, crowd))
    assert (got[300 + len(crowd) + 150 : 300 + len(crowd) + 210] == -1).all()
    assert (got[-40:-20] == -1).all()          # length 0: no slot matches


def _long_key_table(seed):
    """A vhash8 table built by _build_vocab_hash8 from keys of lengths 0 to
    40 (the first 16 bytes keyed, as for a piece), beside the pieces it
    holds and their ranks."""
    rng = np.random.default_rng(seed)
    pieces = [b""] + [bytes(rng.integers(0, 256, int(k)).astype(np.uint8))
                      for k in rng.integers(1, 41, 1500)]
    pieces = list(dict.fromkeys(pieces))
    qk, ql = _keys(pieces)
    rk = rng.permutation(len(pieces)).astype(np.int32) + 1000
    rows, mask, dropped = TT._build_vocab_hash8(qk, ql, rk)
    want = JT._build_vocab_hash8(qk, ql, rk)
    assert np.array_equal(rows, want[0]) and mask == want[1]
    return qk, ql, rk, rows, mask, dropped


def test_host_build_long_keys_and_an_empty_token():
    """Lengths above 16 and a zero-length entry: a piece of 17-40 bytes
    hits on its first 16 bytes and its length, and a length-0 query hits
    the empty token, since the kernel takes no shortcut for dead slots."""
    qk, ql, rk, rows, mask, dropped = _long_key_table(3)
    rng = np.random.default_rng(4)
    other = rng.integers(0, 2**32, (200, 4), dtype=np.uint64).astype(
        np.uint32)
    ol = rng.integers(-1, 41, 200).astype(np.int32)
    qq = np.concatenate([qk, other, qk[:50]])
    qn = np.concatenate([ql, ol, ql[:50] + 1])     # wrong lengths miss
    got = _host_probe(qq, qn, rows, mask)
    assert np.array_equal(got, _jax_probe(qq, qn, rows, mask))
    assert np.array_equal(got, JJ.vocab_probe8_np(qq, qn, rows, mask))
    assert np.array_equal(got, _plain(qq, qn, rows, mask))
    hits = got[: len(ql)]
    assert (hits >= 0).sum() == len(ql) - dropped
    assert ((hits == rk) | (hits == -1)).all()
    assert hits[0] == rk[0]                        # the empty token
    assert (ql[hits >= 0] > 16).any()


def test_host_build_dead_lengths(table):
    """Every query length in {-1, 0}, with zero keys and with random keys,
    against a table built by _build_vocab_hash8: length 0 never matches (an
    empty slot holds -1); length -1 with zero keys matches an empty slot
    of its bucket, rank 0, as in the plain version."""
    _, _, t = table
    rows, mask = t.vhash8_rows, t.vhash8_mask
    rng = np.random.default_rng(9)
    qk = np.concatenate([
        np.zeros((2, 4), np.uint32),
        rng.integers(0, 2**32, (400, 4), dtype=np.uint64).astype(np.uint32)])
    ql = np.tile(np.array([0, -1], np.int32), len(qk) // 2)
    got = _host_probe(qk, ql, rows, mask)
    assert np.array_equal(got, _jax_probe(qk, ql, rows, mask))
    assert np.array_equal(got, _plain(qk, ql, rows, mask))
    assert got[0] == -1 and got[1] == 0
    assert (got[ql == 0] == -1).all()


def test_host_build_near_misses(table):
    """Queries equal to a table entry in all but one key word or the
    length, chosen to hash to the entry's bucket: each must miss, so
    every word and the length are compared, not only hashed."""
    from tokendagger_tpu_torch.tables import _mix_hash, _vhash_ab

    _, _, t = table
    rows, mask = t.vhash8_rows, t.vhash8_mask
    slots = rows.reshape(-1, 6, 8).transpose(0, 2, 1).reshape(-1, 6)
    live = slots[slots[:, 4] > 0]
    rng = np.random.default_rng(12)
    ent = live[rng.choice(len(live), 24, replace=False)]
    qk, ql = [], []
    for e in ent:
        h = _mix_hash(*_vhash_ab(*(np.array([x], np.int32) for x in e[:5])),
                      0, mask)[0]
        for j in range(5):
            cand = np.repeat(e[None, :5], 1 << 16, axis=0).astype(np.int64)
            cand[:, j] = rng.integers(-(2**31), 2**31, 1 << 16)
            c32 = cand.astype(np.int32)
            hc = _mix_hash(*_vhash_ab(*(c32[:, i] for i in range(5))), 0,
                           mask)
            pick = c32[(hc == h) & (c32[:, j] != e[j])][0]
            qk.append(pick[:4].view(np.uint32))
            ql.append(pick[4])
    qk, ql = np.array(qk, np.uint32), np.array(ql, np.int32)
    got = _host_probe(qk, ql, rows, mask)
    assert np.array_equal(got, _jax_probe(qk, ql, rows, mask))
    assert np.array_equal(got, _plain(qk, ql, rows, mask))
    assert (got == -1).all()
    hits = _host_probe(ent[:, :4].view(np.uint32), ent[:, 4].copy(), rows,
                       mask)
    assert (hits == ent[:, 5]).all()


def test_host_build_batched_rows(table):
    """A (B, P) query as the batch pipelines give it: the flattened host
    build equals the plain version on the 2-D tensors."""
    ranks, crowd, t = table
    qk, ql, _ = _queries(ranks, crowd, 2)
    n = (len(ql) // 4) * 4
    qk, ql = qk[:n], ql[:n]
    got = _host_probe(qk, ql, t.vhash8_rows, t.vhash8_mask)
    qi = qk.view(np.int32).reshape(4, n // 4, 4)
    want = TJ.vocab_probe8(
        *(torch.from_numpy(qi[..., j].copy()) for j in range(4)),
        torch.from_numpy(ql.reshape(4, -1)),
        torch.from_numpy(t.vhash8_rows), t.vhash8_mask)
    assert want.shape == (4, n // 4) and want.dtype == torch.int32
    assert np.array_equal(got.reshape(4, -1), want.numpy())


def test_cpu_tensors_never_load_the_cuda_library(table, monkeypatch):
    """vocab_probe8 on CPU tensors runs the plain version: it neither
    builds nor loads the kernel's library, nor counts a launch."""
    from tokendagger_tpu_torch import _build

    def refuse(*a, **k):
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(TJ, "_library", refuse)
    monkeypatch.setattr(_build, "cuda_library", refuse)
    ranks, crowd, t = table
    qk, ql, _ = _queries(ranks, crowd, 3)
    qi = qk.view(np.int32)
    before = TJ.vocab_probe8.launches
    got = TJ.vocab_probe8(
        *(torch.from_numpy(qi[:, j].copy()) for j in range(4)),
        torch.from_numpy(ql), torch.from_numpy(t.vhash8_rows),
        t.vhash8_mask)
    assert TJ.vocab_probe8.launches == before
    assert np.array_equal(got.numpy(), _plain(qk, ql, t.vhash8_rows,
                                               t.vhash8_mask))
    empty = torch.zeros((2, 0), dtype=torch.int32)
    out = TJ.vocab_probe8(empty, empty, empty, empty, empty,
                          torch.from_numpy(t.vhash8_rows), t.vhash8_mask)
    assert out.shape == (2, 0) and out.dtype == torch.int32


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "width",
                                 "mask", "device"])
def test_vocab_probe8_rejects_bad_inputs(table, bad):
    _, _, t = table
    rows = torch.from_numpy(t.vhash8_rows)
    mask = t.vhash8_mask
    q = [torch.zeros(64, dtype=torch.int32) for _ in range(5)]
    if bad == "dtype":
        q[2] = q[2].to(torch.int64)
    elif bad == "shape":
        q[4] = torch.zeros(63, dtype=torch.int32)
    elif bad == "strided":
        q[1] = torch.zeros(128, dtype=torch.int32)[::2]
    elif bad == "width":
        rows = rows[:, :24].contiguous()
    elif bad == "mask":
        mask = mask - 1
    else:
        q = [x.to("meta") for x in q]
        rows = rows.to("meta")
    with pytest.raises(ValueError):
        TJ.vocab_probe8(*q, rows, mask)
