"""Port of ops/compact_pallas (K2+K3 piece keys, K4 masked compaction,
finalize) held against the JAX package's Pallas kernels in interpret mode
and the sort-based reference, bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tokendagger_tpu.ops import compact_pallas as JC
from tokendagger_tpu.ops.bitplane import pack_mask as jpack
from tokendagger_tpu.ops.fused import caps_for
from tokendagger_tpu.ops.join import compact_piece_keys_sorted
from tokendagger_tpu_torch.ops import compact as TC
from tokendagger_tpu_torch.ops.fused import caps_for as t_caps_for

NAMES = ["start_b", "piece_len", "k0", "k1", "k2", "k3", "n_pieces"]


def _as_i32(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def _port(starts, data, nbytes, p_cap, packed=False):
    out = TC.compact_piece_keys(
        torch.from_numpy(starts), torch.from_numpy(data),
        torch.from_numpy(nbytes), p_cap, packed=packed)
    return [o.numpy() for o in out]


def _check_vs_butterfly(starts, data, nbytes, p_cap, **kw):
    want = JC.compact_piece_keys_butterfly(
        jnp.asarray(starts), jnp.asarray(data), jnp.asarray(nbytes), p_cap,
        interpret=True, **kw)
    got = _port(starts, data, nbytes, p_cap)
    for nm, w, g in zip(NAMES, want, got):
        assert np.array_equal(_as_i32(w), g), nm
    return got


def _check_vs_sorted(starts, data, nbytes, p_cap, got):
    for b in range(starts.shape[0]):
        want = compact_piece_keys_sorted(
            jnp.asarray(starts[b]), jnp.asarray(data[b]),
            jnp.int32(nbytes[b]), p_cap)
        for nm, w, g in zip(NAMES, want, [o[b] for o in got]):
            assert np.array_equal(_as_i32(w), g), (b, nm)


def test_caps_match_jax():
    for n in (1 << 10, 1 << 15, 1 << 20, 123457):
        for bpp in (3.0, 4.0):
            assert t_caps_for(n, bpp) == caps_for(n, bpp)
    assert t_caps_for(1 << 20)["p_cap"] == 349_568


def test_piece_keys_random():
    rng = np.random.default_rng(1)
    B, N = 3, 1 << 16
    p_cap = caps_for(N)["p_cap"]
    data = rng.integers(32, 127, (B, N)).astype(np.uint8)
    starts = rng.random((B, N)) < 0.22
    starts[:, 0] = True
    nbytes = np.array([N, N - 1000, 333], np.int32)
    got = _check_vs_butterfly(starts, data, nbytes, p_cap)
    _check_vs_sorted(starts, data, nbytes, p_cap, got)


@pytest.mark.parametrize("case", ["none", "one", "sparse", "dense", "tail"])
def test_piece_keys_edge_densities(case):
    rng = np.random.default_rng(2)
    B, N = 1, 1 << 15
    p_cap = caps_for(N)["p_cap"]
    data = rng.integers(32, 127, (B, N)).astype(np.uint8)
    starts = np.zeros((B, N), bool)
    nbytes = np.array([N], np.int32)
    if case == "one":
        starts[0, 0] = True
    elif case == "sparse":
        starts[0] = rng.random(N) < 0.02
    elif case == "dense":
        starts[0, ::4] = True
    elif case == "tail":  # flags and bytes beyond nbytes are ignored
        starts[0] = rng.random(N) < 0.3
        nbytes[0] = N - 777
        data[0, N - 777:] = rng.integers(0, 256, 777)
    got = _check_vs_butterfly(starts, data, nbytes, p_cap)
    _check_vs_sorted(starts, data, nbytes, p_cap, got)


def test_piece_keys_overflow():
    """Denser than p_cap: n_pieces reveals it; the kept slots still equal
    the butterfly's (the last kept piece ends at nbytes)."""
    rng = np.random.default_rng(3)
    B, N = 1, 1 << 15
    p_cap = caps_for(N)["p_cap"]
    data = rng.integers(32, 127, (B, N)).astype(np.uint8)
    starts = np.ones((B, N), bool)
    nbytes = np.array([N], np.int32)
    got = _check_vs_butterfly(starts, data, nbytes, p_cap)
    assert int(got[6][0]) == N > p_cap


def test_piece_keys_packed_flags():
    """Plane-major packed flags (the K1 output) equal the bool path and
    the butterfly's packed mode (tile_rows=8 makes N == 32 * tile)."""
    rng = np.random.default_rng(11)
    B, N = 2, 1 << 15
    p_cap = caps_for(N)["p_cap"]
    data = rng.integers(32, 127, (B, N)).astype(np.uint8)
    starts = rng.random((B, N)) < 0.22
    starts[:, 0] = True
    nbytes = np.array([N, N - 4321], np.int32)
    words = np.array(jax.vmap(jpack)(jnp.asarray(starts)))
    want = JC.compact_piece_keys_butterfly(
        jnp.asarray(words), jnp.asarray(data), jnp.asarray(nbytes), p_cap,
        interpret=True, packed=True, tile_rows=8)
    got = _port(words.view(np.int32), data, nbytes, p_cap, packed=True)
    plain = _port(starts, data, nbytes, p_cap)
    for nm, w, g, p in zip(NAMES, want, got, plain):
        assert np.array_equal(_as_i32(w), g), nm
        assert np.array_equal(p, g), nm


@pytest.mark.parametrize("fill", [0, -1, 7])
def test_compact_by_mask(fill):
    rng = np.random.default_rng(fill + 10)
    B, P = 3, 4096
    vals = [rng.integers(-2**31, 2**31, (B, P)).astype(np.int32)
            for _ in range(3)]
    mask = rng.random((B, P)) < 0.3
    mask[1] = False
    mask[2] = True
    want = JC.compact_by_mask([jnp.asarray(v) for v in vals],
                              jnp.asarray(mask), interpret=True, fill=fill)
    got = TC.compact_by_mask([torch.from_numpy(v) for v in vals],
                             torch.from_numpy(mask), fill=fill)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_finalize():
    rng = np.random.default_rng(5)
    B, N = 3, 1 << 15
    p_cap = caps_for(N)["p_cap"]
    data = rng.integers(32, 127, (B, N)).astype(np.uint8)
    starts = rng.random((B, N)) < 0.25
    starts[2] = True  # overflow window
    nbytes = np.array([N, 5000, N], np.int32)
    sb, pl, _, _, _, _, npc = _port(starts, data, nbytes, p_cap)
    rank = rng.integers(-1, 1000, (B, p_cap)).astype(np.int32)
    rank[rng.random((B, p_cap)) < 0.5] = -1
    want = JC.finalize_butterfly(
        jnp.asarray(sb), jnp.asarray(pl), jnp.asarray(rank),
        jnp.asarray(npc), jnp.int32(N), p_cap=p_cap, interpret=True)
    got = TC.finalize(torch.from_numpy(sb), torch.from_numpy(pl),
                      torch.from_numpy(rank), torch.from_numpy(npc),
                      p_cap=p_cap)
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(w), g.numpy()), i


def test_wrappers_check_inputs():
    data = torch.zeros((1, 1024), dtype=torch.uint8)
    nb = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        TC.compact_piece_keys(torch.zeros((1, 1000), dtype=torch.bool),
                              data, nb, 512)
    with pytest.raises(ValueError):
        TC.compact_piece_keys(torch.zeros((1, 32), dtype=torch.int64),
                              data, nb, 512, packed=True)
    with pytest.raises(ValueError):
        TC.compact_by_mask([torch.zeros((1, 8), dtype=torch.int64)],
                           torch.zeros((1, 8), dtype=torch.bool))
