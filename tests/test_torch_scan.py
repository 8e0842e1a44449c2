"""The rest of the port's ``ops/pretokenize``: the sorted and ASCII decodes,
the char-per-element scans (``match_lengths``, ``chain_starts``,
``piece_starts``), ``compute_starts``, ``compact_pieces``, ``scan_bytes``
and the two-level class table, held against the JAX package's functions
bit for bit, on the CPU."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_piece_starts import FIXED_CASES, POOLS
from tests.test_sorted_compaction import _trim_to_char, _windows
from tests.test_torch_pretokenize import _edge_bytes
from tokendagger_tpu.ops import pretokenize as JP
from tokendagger_tpu.unicode_tables import get_two_level_tables as jax_tables
from tokendagger_tpu_torch import scanner_ref as SR
from tokendagger_tpu_torch.ops import pretokenize as TP
from tokendagger_tpu_torch.ops.bitplane import (
    piece_starts_chars_plain, unpack_mask,
)
from tokendagger_tpu_torch.unicode_tables import get_two_level_tables
from torch_port_util import multiscript_text

N = 1 << 12
PROFILES = ["llama4", "nocontract", "cl100k", "gpt2"]
PAGE_IDS, PAGES = get_two_level_tables()
J_TABLES = tuple(map(jnp.asarray, jax_tables()))


def _eq(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want))


def test_two_level_tables_equal_jax():
    page_ids, pages = jax_tables()
    assert PAGE_IDS.dtype == np.asarray(page_ids).dtype
    assert np.array_equal(PAGE_IDS, np.asarray(page_ids).reshape(-1))
    assert np.array_equal(PAGES, pages) and PAGES.dtype == np.uint8
    assert PAGE_IDS.shape == (0x1100,)


def _window_cases():
    cases = {k: _trim_to_char(v) for k, v in _windows().items()}
    cases["edge"] = _edge_bytes(3, N).tobytes()
    return cases


def _pad(raw: bytes, garbage: bool = False):
    rng = np.random.default_rng(len(raw))
    buf = (rng.integers(0, 256, N).astype(np.uint8) if garbage
           else np.zeros(N, np.uint8))
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    return buf, len(raw)


@pytest.mark.parametrize("name", list(_window_cases()))
def test_decode_sorted_equals_jax(name):
    buf, nb = _pad(_window_cases()[name])
    want = JP.utf8_decode_sorted(jnp.asarray(buf), jnp.int32(nb))
    got = TP.utf8_decode_sorted(torch.from_numpy(buf), nb)
    general = TP.utf8_decode(torch.from_numpy(buf), nb)
    for g, w, k in zip(got, want, general):
        assert g.dtype == torch.int32
        assert _eq(g, w) and torch.equal(g, k)


@pytest.mark.parametrize("name", ["lorem", "rand_ascii", "empty", "one"])
@pytest.mark.parametrize("garbage", [False, True])
def test_decode_ascii_equals_jax(name, garbage):
    buf, nb = _pad(_window_cases()[name], garbage)
    want = JP.utf8_decode_ascii(jnp.asarray(buf), jnp.int32(nb))
    got = TP.utf8_decode_ascii(torch.from_numpy(buf), nb)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and _eq(g, w)


def test_decodes_batched_equal_rows():
    rows = np.stack([_edge_bytes(s, N) for s in range(3)])
    nbytes = np.array([N, 17, 0], np.int32)
    for fn in (TP.utf8_decode_sorted, TP.utf8_decode_ascii):
        got = fn(torch.from_numpy(rows), torch.from_numpy(nbytes))
        for r in range(3):
            one = fn(torch.from_numpy(rows[r]), int(nbytes[r]))
            assert all(torch.equal(g[r], o) for g, o in zip(got, one))


def _codepoints(seed: int, n: int = N):
    """(n,) int32 codepoints of seeded multi-script text with fixed cases
    spliced in, 0-padded, and the char count."""
    rng = np.random.default_rng(seed)
    text = "".join(FIXED_CASES) + multiscript_text(rng, n)
    cp = np.frombuffer(text.encode("utf-32-le"), np.uint32).astype(np.int32)
    m = n - n // 40 - seed
    out = np.zeros(n, np.int32)
    out[:m] = cp[:m]
    return out, m


@pytest.mark.parametrize("profile", PROFILES + ["o999k_unknown"])
def test_match_lengths_and_chain_equal_jax(profile):
    cp, m = _codepoints(1)
    want = JP.match_lengths_jax(jnp.asarray(cp), jnp.int32(m), *J_TABLES,
                                profile=profile)
    got = TP.match_lengths(torch.from_numpy(cp), m, PAGE_IDS, PAGES,
                           profile=profile)
    assert got.dtype == torch.int32 and _eq(got, want)
    assert int(got.min()) >= 1
    want_st = JP.chain_starts(want, jnp.int32(m))
    got_st = TP.chain_starts(got, m)
    assert got_st.dtype == torch.bool and _eq(got_st, want_st)
    # the chain is the host scanner's walk over the lengths
    sr = SR.match_lengths(cp[:m].astype(np.int64), profile=profile)
    assert np.array_equal(got[:m].numpy(), sr)
    walk = np.zeros(N, bool)
    i = 0
    while i < m:
        walk[i] = True
        i += int(sr[i])
    assert np.array_equal(got_st.numpy(), walk)


def test_match_lengths_contractions_flag():
    cp, m = _codepoints(2)
    for contractions, profile in ((True, "llama4"), (False, "nocontract")):
        got = TP.match_lengths(torch.from_numpy(cp), m, PAGE_IDS, PAGES,
                               contractions=contractions)
        want = TP.match_lengths(torch.from_numpy(cp), m, PAGE_IDS, PAGES,
                                profile=profile)
        assert torch.equal(got, want)


def test_chain_starts_edges():
    lens = torch.tensor([[3, 1, 9, 1, 1, 1, 1, 1],
                         [0, 0, 0, 0, 0, 0, 0, 0],
                         [8, 1, 1, 1, 1, 1, 1, 1]], dtype=torch.int32)
    m = torch.tensor([8, 5, 0], dtype=torch.int32)
    for r in range(3):
        want = JP.chain_starts(jnp.asarray(lens[r].numpy()),
                               jnp.int32(int(m[r])))
        assert _eq(TP.chain_starts(lens, m)[r], want)


def _rows(texts, n):
    cp = np.zeros((len(texts), n), np.int32)
    m = np.zeros(len(texts), np.int32)
    for b, t in enumerate(texts):
        c = np.frombuffer(t.encode("utf-32-le"), np.uint32).astype(np.int32)
        cp[b, : len(c)] = c[:n]
        m[b] = min(len(c), n)
    return cp, m


def _pool_texts(seed: int, k: int):
    rng = random.Random(seed)
    out = []
    for _ in range(k):
        parts = []
        for _ in range(rng.randint(40, 150)):
            pool = rng.choice(POOLS)
            parts.append("".join(rng.choice(pool)
                                 for _ in range(rng.randint(1, 6))))
        out.append("".join(parts)[:1000])
    return out


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("rows", ["fixed", "pools"])
def test_piece_starts_equals_jax_and_references(profile, rows):
    """Rows of the fixed cases (width 64) or of pool fuzz (width 1024):
    the char form against the JAX ``piece_starts_jax`` row by row, the
    host scanner and K1's plain version (``piece_starts_chars_plain``)."""
    texts = FIXED_CASES if rows == "fixed" else _pool_texts(0xD06, 6)
    cp, m = _rows(texts, 64 if rows == "fixed" else 1024)
    got = TP.piece_starts(torch.from_numpy(cp), torch.from_numpy(m),
                          PAGE_IDS, PAGES, profile=profile)
    assert got.dtype == torch.bool and got.shape == cp.shape
    bits = unpack_mask(piece_starts_chars_plain(
        torch.from_numpy(cp), torch.from_numpy(m), profile=profile))
    assert torch.equal(got, bits)
    for b in range(len(texts)):
        want = JP.piece_starts_jax(jnp.asarray(cp[b]), jnp.int32(int(m[b])),
                                   *J_TABLES, profile=profile)
        assert _eq(got[b], want), (profile, texts[b])
        one = TP.piece_starts(torch.from_numpy(cp[b]), int(m[b]), PAGE_IDS,
                              PAGES, profile=profile)
        assert torch.equal(one, got[b])
        sr = SR.piece_starts(cp[b, : m[b]].astype(np.int64), profile=profile)
        assert np.array_equal(got[b, : m[b]].numpy(), sr)
        assert not got[b, m[b]:].any()


def test_piece_starts_window_equals_jax():
    cp, m = _codepoints(4)
    for profile in PROFILES:
        want = JP.piece_starts_jax(jnp.asarray(cp), jnp.int32(m), *J_TABLES,
                                   profile=profile)
        got = TP.piece_starts(torch.from_numpy(cp), m, PAGE_IDS, PAGES,
                              profile=profile)
        assert _eq(got, want), profile


def test_piece_starts_unknown_profile_raises():
    cp, m = _codepoints(5, 64)
    with pytest.raises(NotImplementedError):
        TP.piece_starts(torch.from_numpy(cp), m, PAGE_IDS, PAGES,
                        profile="o999k_nonexistent")


@pytest.mark.parametrize("profile", PROFILES + ["o999k_unknown", None])
def test_compute_starts_equals_jax(profile):
    cp, m = _codepoints(6)
    kw = dict(contractions=profile is not None, profile=profile)
    want = JP.compute_starts(jnp.asarray(cp), jnp.int32(m), *J_TABLES, **kw)
    got = TP.compute_starts(torch.from_numpy(cp), m, PAGE_IDS, PAGES, **kw)
    assert got.dtype == torch.bool and _eq(got, want)


@pytest.mark.parametrize("name", ["emoji", "mixed", "edge", "empty"])
def test_compact_pieces_equals_jax(name):
    buf, nb = _pad(_window_cases()[name], garbage=True)
    cp, _, boc, m = TP.utf8_decode(torch.from_numpy(buf), nb)
    starts = TP.piece_starts(cp, m, PAGE_IDS, PAGES)
    want = JP.compact_pieces(jnp.asarray(starts.numpy()),
                             jnp.asarray(boc.numpy()), jnp.int32(nb))
    got = TP.compact_pieces(starts, boc, nb)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and _eq(g, w)
    both = TP.compact_pieces(torch.stack([starts, starts]),
                             torch.stack([boc, boc]),
                             torch.tensor([nb, nb], dtype=torch.int32))
    assert all(torch.equal(b[1], g) for b, g in zip(both, got))


@pytest.mark.parametrize("profile", ["llama4", "gpt2", "o999k_unknown"])
def test_scan_bytes_equals_jax(profile):
    buf, nb = _pad(_window_cases()["edge"][: N - 321], garbage=True)
    want = JP.scan_bytes(jnp.asarray(buf), jnp.int32(nb), *J_TABLES,
                         profile=profile)
    got = TP.scan_bytes(torch.from_numpy(buf), nb, PAGE_IDS, PAGES,
                        profile=profile, use_pallas=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and _eq(g, w)
    assert int(got[2]) > 100
