"""The port's pair-merge tables, device BPE merge (plain versions and the
kernel's row routines built for the host) and sort join against the JAX
package, bit for bit, on the CPU."""

import ctypes
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_tiny_vocab
from tokendagger_tpu.ops import join as JJ
from tokendagger_tpu.ops import merge as JM
from tokendagger_tpu.tables import build_tables
from tokendagger_tpu_torch.convert import (
    merge_tables_from_ranks, merge_tables_from_reference,
)
from tokendagger_tpu_torch.hostengine import byte_pair_merge
from tokendagger_tpu_torch.ops import join as PJ
from tokendagger_tpu_torch.ops import merge as M
from tokendagger_tpu_torch.tables import MAX_RANK, PairTable, build_pair_table
from torch_port_util import collision_vocab, merge_rows_np, merge_vocab

VOCABS = {
    "tiny": lambda: make_tiny_vocab()[0],
    "merge": lambda: merge_vocab()[0],
    "collision": lambda: collision_vocab(3)[0],
}


@pytest.fixture(scope="module")
def merge_ref():
    """(ranks, JAX tables, port tables) of ``merge_vocab``."""
    ranks, specials = merge_vocab()
    return (ranks, build_tables(ranks, specials, use_cache=False),
            merge_tables_from_ranks(ranks, device="cpu"))


@pytest.mark.parametrize("vocab", sorted(VOCABS))
def test_merge_tables_equal_reference(vocab):
    ranks = VOCABS[vocab]()
    ref = build_tables(ranks, {}, use_cache=False)
    pair = build_pair_table(ranks)
    assert np.array_equal(pair.rows, ref.pair.rows)
    assert (pair.mask, pair.n_keys) == (ref.pair.mask, ref.pair.n_keys)
    mt = merge_tables_from_ranks(ranks, device="cpu")
    assert np.array_equal(mt.pair_rows.numpy(), ref.pair.rows)
    assert mt.pair_mask == ref.pair.mask
    assert np.array_equal(mt.byte_rank.numpy(), ref.byte_rank)
    assert np.array_equal(mt.pair_lut.numpy(), ref.pair_lut)
    assert np.array_equal(mt.vk.numpy().view(np.uint32), ref.vocab_keys)
    assert np.array_equal(mt.vlen.numpy(), ref.vocab_lens)
    assert np.array_equal(mt.vrank.numpy(), ref.vocab_ranks)
    rng = np.random.default_rng(0)
    a = rng.integers(-1, len(ranks), 5000).astype(np.int32)
    b = rng.integers(-1, len(ranks), 5000).astype(np.int32)
    assert np.array_equal(pair.lookup_np(a, b), ref.pair.lookup_np(a, b))


def test_pair_table_build_equals_reference_on_random_keys():
    """The table of random id pairs equals the JAX package's, and every
    key is found."""
    from tokendagger_tpu.tables import PairTable as RefPairTable

    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 20, 3000).astype(np.int32)
    b = rng.integers(0, 1 << 20, 3000).astype(np.int32)
    v = np.arange(3000, dtype=np.int32)
    got, want = PairTable.build(a, b, v), RefPairTable.build(a, b, v)
    assert np.array_equal(got.rows, want.rows) and got.mask == want.mask
    assert np.array_equal(got.lookup_np(a, b), v)


def test_pair_lookup_equals_jax(merge_ref):
    ranks, ref, mt = merge_ref
    pa, pb = [], []
    for tb in list(ranks)[:2000]:
        for i in range(1, len(tb)):
            if tb[:i] in ranks and tb[i:] in ranks:
                pa.append(ranks[tb[:i]])
                pb.append(ranks[tb[i:]])
    rng = np.random.default_rng(2)
    a = np.concatenate([pa, rng.integers(-1, len(ranks), 3000),
                        [-1, 5, -1]]).astype(np.int32)
    b = np.concatenate([pb, rng.integers(-1, len(ranks), 3000),
                        [5, -1, -1]]).astype(np.int32)
    want = np.asarray(JM.pair_lookup(jnp.asarray(ref.pair.rows),
                                     ref.pair.mask, jnp.asarray(a),
                                     jnp.asarray(b)))
    got = M.pair_lookup(mt.pair_rows, mt.pair_mask, torch.from_numpy(a),
                        torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want)
    assert (want[: len(pa)] != MAX_RANK).all()


@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("C", [16, 64, 256])
def test_merge_rows_local_equals_jax(merge_ref, C, lut):
    ranks, ref, mt = merge_ref
    buf, lens = merge_rows_np(np.random.default_rng(C), 48, C)
    want = JM.merge_rows_local(
        jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(ref.byte_rank),
        jnp.asarray(ref.pair.rows), mask=ref.pair.mask,
        pair_lut=jnp.asarray(ref.pair_lut) if lut else None)
    got = M.merge_rows_local(
        torch.from_numpy(buf), torch.from_numpy(lens), mt.byte_rank,
        mt.pair_rows, mask=mt.pair_mask, pair_lut=mt.pair_lut if lut else None)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    # and the sequential algorithm's ids, row by row
    for r in range(len(lens)):
        piece = buf[r, : lens[r]].tobytes()
        if piece:
            row = got[0][r]
            assert row[row >= 0].tolist() == byte_pair_merge(piece, ranks)


@pytest.mark.parametrize("C", [16, 64, 256])
def test_merge_rows_from_state_equals_jax(merge_ref, C):
    """From a first-round state with every pair looked up in the table."""
    _, ref, mt = merge_ref
    buf, lens = merge_rows_np(np.random.default_rng(C + 1), 32, C)
    tok0, pr0, ln = M._first_state(
        torch.from_numpy(buf), torch.from_numpy(lens), mt.byte_rank,
        mt.pair_rows, mt.pair_mask, None)
    want = JM.merge_rows_from_state(
        jnp.asarray(tok0.numpy()), jnp.asarray(pr0.numpy()),
        jnp.asarray(ln.numpy()), jnp.asarray(ref.pair.rows),
        mask=ref.pair.mask)
    got = M.merge_rows_from_state(tok0, pr0, ln, mt.pair_rows,
                                  mask=mt.pair_mask)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_merge_rows_on_the_cpu_is_the_plain_loop(merge_ref):
    ranks, _, mt = merge_ref
    buf, lens = merge_rows_np(np.random.default_rng(5), 40, 64)
    args = (torch.from_numpy(buf), torch.from_numpy(lens), mt.byte_rank,
            mt.pair_rows)
    before = M.merge_rows.launches
    got = M.merge_rows(*args, mt.pair_mask, mt.pair_lut)
    want = M.merge_rows_local(*args, mask=mt.pair_mask, pair_lut=mt.pair_lut)
    assert M.merge_rows.launches == before      # no kernel on the CPU
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert M.merge_rows(torch.zeros((0, 16), dtype=torch.uint8),
                        torch.zeros(0, dtype=torch.int32), mt.byte_rank,
                        mt.pair_rows, mt.pair_mask)[0].shape == (0, 16)


def _chain_vocab():
    """Ranks over all 256 bytes, every run of 2-256 b"a" and every prefix of
    a seeded 256-byte string S without b"a", whose adjacent pairs but the
    first are no tokens: rows of C b"a" and S[:C] merge C - 1 times into
    one token. Returns (ranks, S)."""
    rng = np.random.default_rng(11)
    chars = [c for c in range(33, 127) if c != ord("a")]
    s = bytes(rng.choice(chars, 256).astype(np.uint8))
    ranks = {bytes([i]): i for i in range(256)}
    for k in range(2, 257):
        ranks[b"a" * k] = len(ranks)
    for k in range(2, 257):
        ranks[s[:k]] = len(ranks)
    return ranks, s


@lru_cache(maxsize=None)
def _host_tables(vocab: str):
    """The port's merge tables of the chain or the collision vocabulary."""
    ranks = _chain_vocab()[0] if vocab == "chain" else collision_vocab(3)[0]
    return merge_tables_from_ranks(ranks, device="cpu")


def _edge_rows(rng, C: int, chain: bytes):
    """``merge_rows_np``'s 48 rows with rows 9-16 replaced: lengths 0 and 1
    between rows of length C, S[:C] (row 14), C b"a" (row 15) and C
    spaces (row 16), with the old bytes left as garbage past each
    length."""
    buf, lens = merge_rows_np(rng, 48, C)
    wide = [bytes(rng.integers(32, 127, C).astype(np.uint8)) for _ in (0, 1)]
    for r, row in enumerate([b"", wide[0], b"a", wide[1], b"", chain[:C],
                             b"a" * C, b" " * C], start=9):
        buf[r, : len(row)] = np.frombuffer(row, np.uint8)
        lens[r] = len(row)
    return buf, lens


def _host_merge(buf, lens, mt, lut, G: int):
    """td_merge_rows_host (csrc/merge_host.cpp) on numpy rows, G lanes a
    row: (tok, counts)."""
    from tokendagger_tpu_torch._build import host_library

    fn = host_library("merge_host").td_merge_rows_host
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, i, i, vp, vp, ctypes.c_uint, vp, vp, vp, i]
    fn.restype = i
    R, C = buf.shape
    buf, lens = np.ascontiguousarray(buf), np.ascontiguousarray(lens)
    br, rows = mt.byte_rank.numpy(), mt.pair_rows.numpy()
    lt = None if lut is None else lut.numpy()
    tok = np.empty((R, C), np.int32)
    cnt = np.empty(R, np.int32)
    assert fn(buf.ctypes.data, lens.ctypes.data, R, C, br.ctypes.data,
              rows.ctypes.data, mt.pair_mask,
              None if lt is None else lt.ctypes.data, tok.ctypes.data,
              cnt.ctypes.data, G) == 0
    return tok, cnt


@pytest.mark.parametrize("vocab", ["merge", "collision", "chain"])
@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("C", [16, 64, 256])
def test_merge_kernel_rows_host_build_equal_plain(merge_ref, C, lut, vocab):
    """The routines each lane group of the merge kernel runs
    (csrc/merge_row.cuh), built for the host (csrc/merge_host.cpp) at 1,
    4, 8 and 32 lanes a row, equal the plain loop on edge rows (lengths 0
    and 1 between long rows, all-tie rows, chains of C - 1 merges, R = 1),
    and, through it (at C = 256), the JAX package's merge_rows_local."""
    chain = _chain_vocab()[1]
    if vocab == "merge":
        _, ref, mt = merge_ref
    else:
        mt = _host_tables(vocab)
    buf, lens = _edge_rows(np.random.default_rng(C + 7), C, chain)
    pl = mt.pair_lut if lut else None
    want = [w.numpy() for w in M.merge_rows_local(
        torch.from_numpy(buf), torch.from_numpy(lens), mt.byte_rank,
        mt.pair_rows, mask=mt.pair_mask, pair_lut=pl)]
    for G in (1, 4, 8, 32):
        got = _host_merge(buf, lens, mt, pl, G)
        assert np.array_equal(got[0], want[0]), G
        assert np.array_equal(got[1], want[1]), G
        one = _host_merge(buf[14:15], lens[14:15], mt, pl, G)
        assert np.array_equal(one[0], want[0][14:15]), G
        assert np.array_equal(one[1], want[1][14:15]), G
    if vocab == "chain":                       # S[:C] and C b"a": one token
        assert want[1][14] == want[1][15] == 1
    if vocab == "merge" and not lut and C == 256:
        jw = JM.merge_rows_local(
            jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(ref.byte_rank),
            jnp.asarray(ref.pair.rows), mask=ref.pair.mask)
        assert np.array_equal(np.asarray(jw[0]), want[0])
        assert np.array_equal(np.asarray(jw[1]), want[1])


@pytest.mark.parametrize("bad", ["width", "dtype", "mask", "lut"])
def test_merge_rows_rejects_bad_inputs(merge_ref, bad):
    _, _, mt = merge_ref
    buf = torch.zeros((4, 300 if bad == "width" else 16), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int64 if bad == "dtype"
                       else torch.int32)
    mask = mt.pair_mask - 1 if bad == "mask" else mt.pair_mask
    lut = mt.pair_lut[:, :128] if bad == "lut" else None
    with pytest.raises(ValueError):
        M.merge_rows(buf, lens, mt.byte_rank, mt.pair_rows, mask, lut)


def test_merge_tables_from_reference_give_the_same_ids(merge_ref):
    """The JAX package's tables, carried across, merge as the port's
    own."""
    _, ref, mt = merge_ref
    carried = merge_tables_from_reference(
        ref.byte_rank, ref.pair.rows, ref.pair.mask, ref.pair_lut,
        ref.vocab_keys, ref.vocab_lens, ref.vocab_ranks, device="cpu")
    for f in ("byte_rank", "pair_rows", "pair_lut", "vk", "vlen", "vrank"):
        assert torch.equal(getattr(carried, f), getattr(mt, f)), f
    buf, lens = merge_rows_np(np.random.default_rng(6), 40, 256)
    got = M.merge_rows(torch.from_numpy(buf), torch.from_numpy(lens),
                       carried.byte_rank, carried.pair_rows,
                       carried.pair_mask, carried.pair_lut)
    want = M.merge_rows(torch.from_numpy(buf), torch.from_numpy(lens),
                        mt.byte_rank, mt.pair_rows, mt.pair_mask, mt.pair_lut)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="pair_mask"):
        merge_tables_from_reference(
            ref.byte_rank, ref.pair.rows, ref.pair.mask * 2 + 1,
            ref.pair_lut, ref.vocab_keys, ref.vocab_lens, ref.vocab_ranks,
            device="cpu")


def _queries(ranks, rng, n):
    """Key words and lengths of vocab tokens (of at most 16 bytes and
    longer), random strings and dead slots (length 0, keys 0)."""
    toks = list(ranks)
    pieces = [toks[int(i)] for i in rng.integers(0, len(toks), n)]
    pieces += [bytes(rng.integers(32, 127, int(k)).astype(np.uint8))
               for k in rng.integers(1, 24, n)]
    pieces += [b"x" * 17, b"x" * 40]
    keys = np.array([PJ.piece_key_words(p) for p in pieces] + [(0,) * 5] * 7,
                    dtype=np.int64)
    return keys, pieces


def test_vocab_join_equals_jax():
    ranks, _ = collision_vocab(4)
    ranks[b"x" * 17] = len(ranks)          # over 16 bytes: never joined
    ref = build_tables(ranks, {}, use_cache=False)
    mt = merge_tables_from_ranks(ranks, device="cpu")
    keys, pieces = _queries(ranks, np.random.default_rng(7), 600)
    words = [PJ.to_i32(torch.from_numpy(keys[:, j])) for j in range(4)]
    qlen = torch.from_numpy(keys[:, 4]).to(torch.int32)
    want = np.asarray(JJ.vocab_join(
        *(jnp.asarray(keys[:, j].astype(np.uint32)) for j in range(4)),
        jnp.asarray(qlen.numpy()), jnp.asarray(ref.vocab_keys),
        jnp.asarray(ref.vocab_lens), jnp.asarray(ref.vocab_ranks)))
    got = PJ.vocab_join(*words, qlen, mt.vk, mt.vlen, mt.vrank)
    assert np.array_equal(got.numpy(), want)
    expect = [ranks.get(p, -1) if len(p) <= 16 else -1 for p in pieces]
    assert got.numpy()[: len(pieces)].tolist() == expect
    assert (got.numpy()[len(pieces):] == -1).all()
    # any leading shape
    n = len(qlen) // 2 * 2
    got2 = PJ.vocab_join(*(w[:n].reshape(2, -1) for w in words),
                         qlen[:n].reshape(2, -1), mt.vk, mt.vlen, mt.vrank)
    assert torch.equal(got2.reshape(-1), got[:n])
    empty = torch.zeros((0, 4), dtype=torch.int32)
    assert (PJ.vocab_join(*words, qlen, empty, empty[:, 0], empty[:, 0])
            == -1).all()
