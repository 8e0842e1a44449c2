"""The port's plain piece-key compactions (``join.compact_piece_keys`` and
``compact_piece_keys_sorted``), ``fused.finalize_host_sorted`` and
``run_resident``'s single-window pipeline (``batch=1``), held against the
JAX package on the CPU: the functions bit for bit, the pipeline against
one JAX ``run_resident`` call each and against the host engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_tiny_vocab
from tests.test_sorted_compaction import _trim_to_char, _windows
from tokendagger_tpu.ops import fused as JF
from tokendagger_tpu.ops import join as JJ
from tokendagger_tpu.ops import pretokenize as JP
from tokendagger_tpu.resident import run_resident as jax_run_resident
from tokendagger_tpu.unicode_tables import get_two_level_tables as jax_tables
from tokendagger_tpu_torch import LLAMA4_PATTERN, run_resident
from tokendagger_tpu_torch.ops import fused as TF
from tokendagger_tpu_torch.ops import join as TJ
from tokendagger_tpu_torch.ops import pretokenize as TP
from torch_port_util import merge_vocab, multiscript_text, prose_text

N = 1 << 12
W = 1 << 15
COMPARED = ("impl", "match_host", "total_tokens", "cap_bpp", "probe_impl",
            "probe_hot", "overflow_windows", "starts_impl", "compact_impl")
KEYS = ("start_b", "piece_len", "k0", "k1", "k2", "k3", "n_pieces")


def _window(name: str):
    """A window of ``test_sorted_compaction`` with garbage beyond its
    length, decoded, with its char-level starts (the JAX CPU starts)."""
    raw = _trim_to_char(_windows()[name])
    rng = np.random.default_rng(len(raw))
    buf = rng.integers(0, 256, N).astype(np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    d, nb = jnp.asarray(buf), jnp.int32(len(raw))
    cp, cob, boc, m = JP.utf8_decode(d, nb)
    starts = JP.compute_starts(cp, m, *map(jnp.asarray, jax_tables()))
    return d, nb, starts, cob, boc


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _as(t: torch.Tensor, like) -> np.ndarray:
    """``t`` viewed as ``like``'s dtype (key words: int32 -> uint32)."""
    return t.numpy().view(np.asarray(like).dtype)


@pytest.mark.parametrize("name", list(_windows()))
@pytest.mark.parametrize("p_cap", [1408, 512])
def test_join_compactions_equal_jax(name, p_cap):
    """Both compactions at caps_for(4096)'s p_cap and at 512, which the
    lorem and mixed windows overflow. The sorted form is held at
    every slot; the scatter form, whose overflowing pieces all write slot
    p_cap - 1, at n_pieces and the slots below p_cap - 2."""
    d, nb, starts, cob, boc = _window(name)
    want = JJ.compact_piece_keys(starts, boc, d, nb, p_cap)
    got = TJ.compact_piece_keys(_t(starts), _t(boc), _t(d), int(nb), p_cap)
    stb = JP.starts_to_bytes(starts, cob, d, nb)
    want_s = JJ.compact_piece_keys_sorted(stb, d, nb, p_cap)
    got_s = TJ.compact_piece_keys_sorted(_t(stb), _t(d), int(nb), p_cap)
    n = int(want[6])
    assert int(got[6]) == int(got_s[6]) == n
    cut = p_cap - 2 if n > p_cap else p_cap
    for label, g, w, gs, ws in zip(KEYS[:6], got, want, got_s, want_s):
        assert g.dtype == gs.dtype == torch.int32
        assert np.array_equal(_as(g, w)[:cut], np.asarray(w)[:cut]), label
        assert np.array_equal(_as(gs, ws), np.asarray(ws)), label
        if n <= p_cap:
            assert torch.equal(g, gs), label
    if name in ("lorem", "mixed") and p_cap == 512:
        assert n > p_cap


def test_join_compactions_batched_equal_rows():
    wins = [_window(name) for name in ("emoji", "mixed", "empty")]
    d = torch.stack([_t(w[0]) for w in wins])
    nb = torch.tensor([int(w[1]) for w in wins], dtype=torch.int32)
    st = torch.stack([_t(w[2]) for w in wins])
    boc = torch.stack([_t(w[4]) for w in wins])
    got = TJ.compact_piece_keys(st, boc, d, nb, 2048)
    got_s = TJ.compact_piece_keys_sorted(
        TP.starts_to_bytes(st, torch.stack([_t(w[3]) for w in wins]), d, nb),
        d, nb, 2048)
    for r in range(3):
        one = TJ.compact_piece_keys(st[r], boc[r], d[r], int(nb[r]), 2048)
        assert all(torch.equal(g[r], o) for g, o in zip(got, one))
        assert all(torch.equal(g[r], o) for g, o in zip(got_s, one))


def _finalize_inputs(seed: int, p_cap: int = 512, n_pieces: int = 301):
    rng = np.random.default_rng(seed)
    start_b = np.sort(rng.choice(4096, size=p_cap, replace=False)).astype(
        np.int32)
    lens = rng.integers(1, 12, p_cap).astype(np.int32)
    start_b[n_pieces:] = 4096
    lens[n_pieces:] = 0
    rank = np.where(rng.random(p_cap) < 0.9, rng.integers(0, 20000, p_cap),
                    -1).astype(np.int32)
    return start_b, lens, rank


@pytest.mark.parametrize("untrimmed,trim", [
    (False, "all"), (False, "half"), (False, "none"), (True, "all")])
@pytest.mark.parametrize("n_pieces", [301, 600])
def test_finalize_host_sorted_equals_jax(untrimmed, trim, n_pieces):
    """``untrimmed`` promises trim >= nbytes, so it takes the full trim;
    600 pieces overflow the 512 slots."""
    p_cap = 512
    start_b, lens, rank = _finalize_inputs(n_pieces, p_cap, min(n_pieces,
                                                                p_cap))
    tr = {"all": 4096, "half": int(start_b[150]) + 3, "none": 0}[trim]
    args = (start_b, lens, rank)
    want = JF.finalize_host_sorted(*map(jnp.asarray, args),
                                   jnp.int32(n_pieces), jnp.int32(tr),
                                   p_cap=p_cap, untrimmed=untrimmed)
    got = TF.finalize_host_sorted(*map(torch.from_numpy, args), n_pieces, tr,
                                  p_cap=p_cap, untrimmed=untrimmed)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # finalize_host (kernel K4's plain version) gives the same tuple
    ref = TF.finalize_host(*(torch.from_numpy(a)[None] for a in args),
                           torch.tensor([n_pieces]), tr, p_cap=p_cap)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), r[0].numpy())


def test_finalize_host_sorted_batched_equals_rows():
    rows = [_finalize_inputs(s) for s in range(3)]
    sb, pl, rk = (torch.from_numpy(np.stack(a)) for a in zip(*rows))
    npc = torch.tensor([301, 0, 512], dtype=torch.int32)
    trim = torch.tensor([4096, 1000, 2500], dtype=torch.int32)
    got = TF.finalize_host_sorted(sb, pl, rk, npc, trim, p_cap=512)
    for r in range(3):
        one = TF.finalize_host_sorted(sb[r], pl[r], rk[r], int(npc[r]),
                                      int(trim[r]), p_cap=512)
        assert all(torch.equal(g[r], o) for g, o in zip(got, one))


# ===========================================================================
# run_resident(batch=1)
# ===========================================================================


@pytest.fixture(scope="module")
def corpora():
    rng = np.random.default_rng(0)
    return {"multiscript": multiscript_text(rng, 3 * W).encode(),
            "ascii": prose_text(np.random.default_rng(1), 3 * W).encode()}


def _both(corpus, ranks, specials, **kw):
    args = (ranks, specials, LLAMA4_PATTERN, corpus)
    kw = dict(window=W, n_windows=2, reps=3, overlap_trial=False, **kw)
    return (run_resident(*args, device="cpu", **kw),
            jax_run_resident(*args, **kw))


@pytest.mark.parametrize("impl,text", [
    ("auto", "multiscript"), ("auto", "ascii"), ("sort", "multiscript"),
    ("ascii-sort", "ascii"), ("scatter", "multiscript"),
])
def test_single_window_equals_jax(corpora, impl, text):
    """reps=3 over 2 windows: the last repetition is the first window
    again, whose token count both report."""
    ranks, specials = make_tiny_vocab()
    got, want = _both(corpora[text], ranks, specials, impl=impl)
    assert want.match_host and got.match_host
    for f in COMPARED:
        assert getattr(got, f) == getattr(want, f), f
    assert got.batch == 1 and got.overlap is None
    assert got.starts_impl == "jnp" and got.compact_impl == "sort"
    assert got.stage_us == {} and got.device_ms == 0.0
    if impl == "auto":
        assert got.impl == ("sort" if text == "multiscript" else "ascii-sort")


def _device_miss_corpus():
    """Prose whose pieces are mostly in ``merge_vocab`` with multi-script
    runs between: the misses fit resolve_window's 32 KB bucket caps."""
    rng = np.random.default_rng(5)
    parts = []
    for _ in range(24):
        parts.append(prose_text(rng, 5 * W // 48))
        parts.append(multiscript_text(rng, W // 48))
    return "".join(parts).encode()


@pytest.mark.parametrize("join_mode", ["probe", "sort"])
def test_single_window_device_misses_equal_jax(join_mode):
    ranks, specials = merge_vocab()
    got, want = _both(_device_miss_corpus(), ranks, specials,
                      miss_mode="device", join_mode=join_mode)
    assert want.match_host and got.match_host
    for f in COMPARED:
        assert getattr(got, f) == getattr(want, f), f
    assert got.impl == "sort" and got.probe_impl == "barrier"
