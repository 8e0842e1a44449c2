"""The port's ``ops/fused.resolve_window`` against the JAX package's on a
64 KB window, bit for bit, both miss modes and both joins: misses in every
bucket width, one oversize piece and a trim inside the window."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokendagger_tpu.ops import fused as JF
from tokendagger_tpu.tables import build_tables
from tokendagger_tpu_torch.convert import (
    merge_tables_from_ranks, merge_tables_from_reference,
)
from tokendagger_tpu_torch.ops import fused as F
from tokendagger_tpu_torch.tables import build_vhash8
from torch_port_util import fused_window


@pytest.fixture(scope="module")
def window():
    ranks, specials, starts, boc, data, nbytes, trim = fused_window(3)
    return dict(ranks=ranks, ref=build_tables(ranks, specials,
                                              use_cache=False),
                starts=starts, boc=boc, data=data, nbytes=nbytes, trim=trim)


def _port(w, tables, miss, join, windows=None):
    """resolve_window of the port on ``windows`` (default: the fixture's
    one) as a batch."""
    windows = windows or [w]
    vh, vmask, _ = build_vhash8(w["ranks"])
    stack = [torch.from_numpy(np.stack([x[k] for x in windows]))
             for k in ("starts", "boc", "data")]
    nb = torch.tensor([x["nbytes"] for x in windows], dtype=torch.int32)
    tr = torch.tensor([x["trim"] for x in windows], dtype=torch.int32)
    return F.resolve_window(
        *stack, nb, tr, tables.byte_rank, tables.pair_rows, tables.pair_lut,
        tables.vk, tables.vlen, tables.vrank, torch.from_numpy(vh),
        mask=tables.pair_mask, vhash_mask=vmask, join_mode=join,
        miss_mode=miss, **F.caps_for(w["data"].shape[0]))


def _jax(w, miss, join):
    t = w["ref"]
    return JF.resolve_window(
        jnp.asarray(w["starts"]), jnp.asarray(w["boc"]),
        jnp.asarray(w["data"]), jnp.int32(w["nbytes"]), jnp.int32(w["trim"]),
        jnp.asarray(t.byte_rank), jnp.asarray(t.pair.rows),
        jnp.asarray(t.pair_lut), jnp.asarray(t.vocab_keys),
        jnp.asarray(t.vocab_lens), jnp.asarray(t.vocab_ranks),
        jnp.asarray(t.vhash8_rows), mask=t.pair.mask,
        vhash_mask=t.vhash8_mask, join_mode=join, miss_mode=miss,
        **JF.caps_for(w["data"].shape[0]))


@pytest.mark.parametrize("join", ["probe", "sort"])
@pytest.mark.parametrize("miss", ["host", "device"])
def test_resolve_window_equals_jax(window, miss, join):
    tables = merge_tables_from_ranks(window["ranks"], device="cpu")
    got = _port(window, tables, miss, join)
    want = _jax(window, miss, join)
    for name, g, x in zip(("flat", "total", "n_pieces", "n_kept", "consumed",
                           "overflow", "span_start", "span_len", "n_spans"),
                          got, want):
        assert np.array_equal(g[0].numpy(), np.asarray(x)), name
    total, n_spans = int(got[1][0]), int(got[8][0])
    assert not bool(got[5][0]) and 0 < int(got[4][0]) <= window["trim"]
    assert (got[0][0, total:] == -1).all()
    if miss == "device":
        assert n_spans == 1 and int(got[7][0, 0]) == 301   # " " + 300 letters
        assert (got[0][0, :total] == F.SENTINEL).sum() == 1
    else:
        assert n_spans > 20                  # every miss is a host span


def test_resolve_window_fills_every_bucket(window, monkeypatch):
    """The window's misses reach all three merge widths."""
    from tokendagger_tpu_torch.ops import merge as M

    tables = merge_tables_from_ranks(window["ranks"], device="cpu")
    widths = []
    orig = M.merge_rows

    def spy(byte_buf, lengths, *a):
        widths.append((byte_buf.shape[1], int((lengths > 0).sum())))
        return orig(byte_buf, lengths, *a)

    monkeypatch.setattr(M, "merge_rows", spy)
    _port(window, tables, "device", "probe")
    assert [w for w, _ in widths] == [16, 64, 256]
    assert all(n > 0 for _, n in widths), widths


def test_resolve_window_batches_windows(window):
    """Two windows in one batch give each window's own results."""
    other = dict(window)
    _, _, other["starts"], other["boc"], other["data"], other["nbytes"], \
        other["trim"] = fused_window(5)
    other["trim"] = other["nbytes"]            # a complete window
    tables = merge_tables_from_ranks(window["ranks"], device="cpu")
    both = _port(window, tables, "device", "sort", [window, other])
    for i, w in enumerate((window, other)):
        one = _port(w, tables, "device", "sort")
        for b, o in zip(both, one):
            assert torch.equal(b[i], o[0])


def test_resolve_window_overflow_flags(window):
    """A bucket over its cap sets the overflow flag."""
    tables = merge_tables_from_ranks(window["ranks"], device="cpu")
    vh, vmask, _ = build_vhash8(window["ranks"])
    caps = dict(F.caps_for(window["data"].shape[0]), m64=1)
    args = [torch.from_numpy(window[k])[None]
            for k in ("starts", "boc", "data")]
    out = F.resolve_window(
        *args, window["nbytes"], window["trim"], tables.byte_rank,
        tables.pair_rows, tables.pair_lut, tables.vk, tables.vlen,
        tables.vrank, torch.from_numpy(vh), mask=tables.pair_mask,
        vhash_mask=vmask, miss_mode="device", **caps)
    assert bool(out[5][0])
    with pytest.raises(ValueError, match="miss_mode"):
        F.resolve_window(
            *args, window["nbytes"], window["trim"], tables.byte_rank,
            tables.pair_rows, tables.pair_lut, tables.vk, tables.vlen,
            tables.vrank, torch.from_numpy(vh), mask=tables.pair_mask,
            vhash_mask=vmask, miss_mode="merge", **caps)


def test_reference_tables_give_the_same_window(window):
    """merge_tables_from_reference feeds resolve_window the JAX package's
    tables; the ids equal those from the port's own tables."""
    t = window["ref"]
    carried = merge_tables_from_reference(
        t.byte_rank, t.pair.rows, t.pair.mask, t.pair_lut, t.vocab_keys,
        t.vocab_lens, t.vocab_ranks, device="cpu")
    own = merge_tables_from_ranks(window["ranks"], device="cpu")
    for join in ("probe", "sort"):
        a = _port(window, carried, "device", join)
        b = _port(window, own, "device", join)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
