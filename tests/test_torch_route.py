"""Port of the recorded-route kernels (K5+K6 ``compact_record``, K7+K8
``expand_route``) and of the general pipeline's decode and expansion
(``utf8_decode_tiles``, ``expand_starts_replay``), held against the JAX
package's Pallas kernels in interpret mode, exactly, on the outputs the
JAX functions define."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokendagger_tpu.ops import compact_pallas as JC
from tokendagger_tpu.ops import pretokenize as JP
from tokendagger_tpu.unicode_tables import get_override_cps
from tokendagger_tpu_torch.ops import compact as TC
from tokendagger_tpu_torch.ops import pretokenize as TP
from torch_port_util import multiscript_text

B, N, CAP = 2, 1 << 16, 1 << 15


def _masks(case: str, rng):
    mask = rng.random((B, N)) < 0.4
    if case == "skewed":          # one tile empty, the other dense
        mask[1, : N // 2] = False
        mask[1, N // 2 :] = rng.random(N // 2) < 0.9
    elif case == "empty_full":    # an empty row; an all-kept row overflows
        mask[0] = False
        mask[1] = True
    return mask


def _jax_route(vals, mask, cap, fill):
    """JAX K5+K6 then K7+K8 of the first dense array (the composition the
    JAX package's four callers make): (dense arrays, totals, back)."""
    gapped, cnts, tile_takes = JC.compact_tiles_masked(
        [jnp.asarray(v) for v in vals], jnp.asarray(mask), out_cap=cap,
        interpret=True)
    dense, degap_takes = JC.degap_record(
        list(gapped), cnts, p_rows=cap // 128, interpret=True, fill=fill)
    dense = [np.asarray(d).reshape(B, cap) for d in dense]
    gap = JC.regap_replay(jnp.asarray(dense[0]), degap_takes,
                          cnts.shape[1] * 128, interpret=True)
    back = JC.expand_tiles_replay(gap, jnp.asarray(mask), tile_takes, cnts,
                                  interpret=True)
    return dense, np.asarray(cnts).sum(axis=1), np.asarray(back)


@pytest.mark.parametrize("nv", [1, 5])
@pytest.mark.parametrize("case", ["skewed", "empty_full"])
def test_compact_record_and_expand_equal_jax(nv, case):
    rng = np.random.default_rng(nv * 10 + len(case))
    vals = [rng.integers(-2**31, 2**31, (B, N)).astype(np.int32)
            for _ in range(nv)]
    mask = _masks(case, rng)
    fill = -7 if nv == 5 else 0
    want_dense, want_tot, want_back = _jax_route(vals, mask, CAP, fill)
    dense, totals, route = TC.compact_record(
        [torch.from_numpy(v) for v in vals], torch.from_numpy(mask),
        cap=CAP, fill=fill)
    assert np.array_equal(totals.numpy(), want_tot)
    back = TC.expand_route(dense[0], route, torch.from_numpy(mask)).numpy()
    for b in range(B):
        kept = int(want_tot[b])
        if kept > CAP:
            # overflow: the flag and the first cap slots are defined
            assert totals[b] > CAP
            for w, g in zip(want_dense, dense):
                assert np.array_equal(w[b], g[b].numpy())
            continue
        for w, g in zip(want_dense, dense):
            assert np.array_equal(w[b], g[b].numpy()), b   # fill beyond
        assert np.array_equal(want_back[b], back[b]), b
        assert np.array_equal(back[b][mask[b]], vals[0][b][mask[b]])
    assert (totals > CAP).any() == (case == "empty_full")
    # the route: each kept element's rank, -1 elsewhere
    r = route.numpy()
    for b in range(B):
        assert np.array_equal(r[b][mask[b]], np.arange(mask[b].sum()))
        assert (r[b][~mask[b]] == -1).all()


def test_expand_route_beyond_cap_and_narrower_mask():
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random((2, 5000)) < 0.5)
    vals = torch.from_numpy(rng.integers(1, 100, (2, 5000)).astype(np.int32))
    (dense,), totals, route = TC.compact_record([vals], mask, cap=1000)
    back = TC.expand_route(dense, route, mask)
    ok = mask & (route < 1000)
    assert torch.equal(back[ok], vals[ok])
    assert not back[~ok].any() and (totals > 1000).all()
    sub = mask & torch.from_numpy(rng.random((2, 5000)) < 0.5)
    assert torch.equal(TC.expand_route(dense, route, sub)[~sub],
                       torch.zeros(int((~sub).sum()), dtype=torch.int32))


def test_route_wrappers_check_inputs():
    mask = torch.zeros((2, 64), dtype=torch.bool)
    a = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        TC.compact_record([a.to(torch.int64)], mask, cap=8)
    with pytest.raises(ValueError):
        TC.compact_record([a] * 9, mask, cap=8)
    with pytest.raises(ValueError):
        TC.compact_record([a], mask, cap=0)
    with pytest.raises(ValueError):
        TC.compact_record([a], mask.to(torch.uint8), cap=8)
    with pytest.raises(ValueError):
        TC.expand_route(torch.zeros((2, 8), dtype=torch.int32),
                        a[:, :10].contiguous(), mask)


# ---------------------------------------------------------------------------
# The general pipeline's decode and its inverse
# ---------------------------------------------------------------------------


def _utf8_batch(seed: int):
    """(B, N) windows of 1-4-byte text with the calibrated codepoints
    (those whose class the tiktoken oracle fixes) mixed in, char-aligned,
    garbage beyond each length."""
    rng = np.random.default_rng(seed)
    ov = np.asarray(sorted(get_override_cps()), np.int64)
    ov = ov[(ov < 0xD800) | (ov > 0xDFFF)]
    by = rng.integers(0, 256, (B, N)).astype(np.uint8)
    nb = np.zeros(B, np.int32)
    for b in range(B):
        parts, size = [], 0
        while size < N * 0.45:
            s = (chr(int(rng.choice(ov))) if rng.random() < 0.3
                 else multiscript_text(rng, 8))
            parts.append(s)
            size += len(s.encode())
        raw = "".join(parts).encode()[: N - 1000 * b]
        raw = raw.decode("utf-8", errors="ignore").encode()
        by[b, : len(raw)] = np.frombuffer(raw, np.uint8)
        nb[b] = len(raw)
    return by, nb


def test_utf8_decode_tiles_and_expand_equal_jax():
    by, nb = _utf8_batch(5)
    c_cap = N // 2
    want = JP.utf8_decode_tiles(jnp.asarray(by), jnp.asarray(nb),
                                c_cap=c_cap, interpret=True)
    cp, lead, n_chars, route = TP.utf8_decode_tiles(
        torch.from_numpy(by), torch.from_numpy(nb), c_cap=c_cap)
    assert np.array_equal(np.asarray(want[0]), cp.numpy())
    assert np.array_equal(np.asarray(want[1]), lead.numpy())
    assert np.array_equal(np.asarray(want[2]), n_chars.numpy())
    assert (n_chars.numpy() <= c_cap).all() and (n_chars.numpy() > 1000).all()
    for b in range(B):
        txt = by[b, : nb[b]].tobytes().decode("utf-8")
        assert np.array_equal(cp[b, : len(txt)].numpy(),
                              [ord(c) for c in txt])
    rng = np.random.default_rng(6)
    flags = rng.random((B, c_cap)) < 0.3
    wf = JP.expand_starts_replay(jnp.asarray(flags), want[1], want[3],
                                 interpret=True)
    got = TP.expand_starts_replay(torch.from_numpy(flags), lead, route)
    assert got.dtype == torch.bool
    assert np.array_equal(np.asarray(wf), got.numpy())


def test_utf8_decode_tiles_more_chars_than_cap():
    """A window with more chars than c_cap: n_chars counts them all (the
    caller's overflow), cp holds the first c_cap, and expansion leaves the
    chars past c_cap unflagged."""
    data = torch.from_numpy(np.frombuffer(b"ab" * 2048, np.uint8).copy())[None]
    nb = torch.tensor([4000], dtype=torch.int32)
    cp, lead, n, route = TP.utf8_decode_tiles(data, nb, c_cap=1024)
    assert int(n[0]) == 4000 and cp.shape == (1, 1024)
    assert cp[0, :4].tolist() == [97, 98, 97, 98]
    flags = TP.expand_starts_replay(torch.ones((1, 1024), dtype=torch.bool),
                                    lead, route)
    assert int(flags.sum()) == 1024 and not flags[0, 1024:].any()
