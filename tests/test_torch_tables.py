"""Port's vhash8 table and the conversion of the JAX package's state,
held equal to tables.build_tables."""

import numpy as np
import pytest
import torch

from tests.conftest import make_tiny_vocab
from tokendagger_tpu import tables as JT
from tokendagger_tpu import unicode_tables as JU
from tokendagger_tpu_torch import convert as TCV
from tokendagger_tpu_torch import tables as TT
from torch_port_util import collision_vocab


@pytest.fixture(scope="module")
def collide():
    ranks, crowd = collision_vocab()
    return ranks, crowd, JT.build_tables(ranks, {}, use_cache=False)


def test_vhash8_equals_jax_tiny():
    ranks, specials = make_tiny_vocab()
    want = JT.build_tables(ranks, specials, use_cache=False)
    rows, mask, dropped = TT.build_vhash8(ranks)
    assert np.array_equal(want.vhash8_rows, rows)
    assert (want.vhash8_mask, want.vhash8_dropped) == (mask, dropped)


def test_vhash8_equals_jax_with_drops(collide):
    ranks, _, want = collide
    rows, mask, dropped = TT.build_vhash8(ranks)
    assert dropped >= 4  # 12 tokens in one 8-slot bucket
    assert np.array_equal(want.vhash8_rows, rows)
    assert (want.vhash8_mask, want.vhash8_dropped) == (mask, dropped)


def test_mix_hash_equals_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    for which in (0, 1):
        assert np.array_equal(JT._mix_hash(a, b, which, 0xFFFF),
                              TT._mix_hash(a, b, which, 0xFFFF))


def test_tables_from_reference_round_trip(collide):
    ranks, _, ref = collide
    classes, folds = JU.get_tables()
    t = TCV.tables_from_reference(ref.vhash8_rows, ref.vhash8_mask,
                                  classes, folds, device="cpu")
    assert t.vhash8_rows.dtype == torch.int32
    assert np.array_equal(t.vhash8_rows.numpy(), ref.vhash8_rows)
    assert t.vhash8_mask == ref.vhash8_mask
    own = TCV.tables_from_ranks(ranks, device="cpu")
    assert torch.equal(own.vhash8_rows, t.vhash8_rows)
    assert own.vhash8_mask == t.vhash8_mask


def test_tables_from_reference_refuses_other_classes(collide):
    _, _, ref = collide
    classes, folds = JU.get_tables()
    other = classes.copy()
    other[ord("a")] ^= JU.NUM
    with pytest.raises(ValueError):
        TCV.tables_from_reference(ref.vhash8_rows, ref.vhash8_mask, other,
                                  folds, device="cpu")
    with pytest.raises(ValueError):
        TCV.tables_from_reference(ref.vhash8_rows[:, :40], ref.vhash8_mask,
                                  classes, folds, device="cpu")


def test_stream_runs_on_converted_tables(collide):
    """ResidentStream on the JAX package's converted tables encodes as it
    does on the tables it builds from the ranks."""
    from tokendagger_tpu_torch import LLAMA4_PATTERN, ResidentStream
    from torch_port_util import prose_text

    ranks, _, ref = collide
    classes, folds = JU.get_tables()
    conv = TCV.tables_from_reference(ref.vhash8_rows, ref.vhash8_mask,
                                     classes, folds, device="cpu")
    text = prose_text(np.random.default_rng(4), 3000).encode()
    outs = [ResidentStream(ranks, {}, LLAMA4_PATTERN, window=4096, batch=1,
                           device="cpu", tables=t).encode(text)[0]
            for t in (None, conv)]
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the 4-slot two-choice table and the merge-reachability audit
# ---------------------------------------------------------------------------


def _growth_vocab():
    """256 bytes, 13 four-byte tokens whose both bucket choices fall in
    three buckets of the first (1,024-bucket) table, so its 12 slots
    overflow and the build must grow, and random filler to ~1,000."""
    rng = np.random.default_rng(11)
    k0 = np.unique(rng.integers(0, 2**32, 3_000_000, dtype=np.uint64)
                   ).astype(np.uint32)
    z = np.zeros_like(k0)
    a, b = TT._vhash_ab(k0, z, z, z, np.full(len(k0), 4, np.int32))
    h0, h1 = TT._mix_hash(a, b, 0, 1023), TT._mix_hash(a, b, 1, 1023)
    both = np.isin(h0, (1, 2, 3)) & np.isin(h1, (1, 2, 3))
    crowd = [int(w).to_bytes(4, "little") for w in k0[both][:13]]
    assert len(crowd) == 13
    ranks = {bytes([i]): i for i in range(256)}
    for tok in crowd:
        ranks.setdefault(tok, len(ranks))
    for w in k0[-700:]:
        ranks.setdefault(int(w).to_bytes(4, "little"), len(ranks))
    return ranks


@pytest.mark.parametrize("vocab", ["tiny", "collision", "growth"])
def test_vocab_hash_equals_jax(vocab):
    ranks = {"tiny": lambda: make_tiny_vocab()[0],
             "collision": lambda: collision_vocab()[0],
             "growth": _growth_vocab}[vocab]()
    want = JT.build_tables(ranks, {}, use_cache=False)
    rows, mask = TT.build_vocab_hash(*TT.vocab_keys(ranks))
    assert rows.dtype == np.int32 and rows.shape == (mask + 1, 24)
    assert np.array_equal(rows, want.vhash_rows)
    assert mask == want.vhash_mask
    if vocab == "growth":   # 1,024 buckets at first, then grown
        assert len(ranks) < 1536 and mask > 1023


def test_audit_equals_jax():
    tiny = make_tiny_vocab()[0]
    bad = {**tiny, b"zqx": 900, b"qzv": 901}   # no merge makes them
    for ranks, want in ((tiny, True), (bad, False)):
        assert TT.all_reachable(ranks) is want
        assert JT.build_tables(ranks, {}, use_cache=False).all_reachable \
            is want
    assert list(TT.unreachable(bad)) == [b"zqx", b"qzv"]
    assert list(TT.unreachable(tiny)) == []
    # a byte without a rank makes its tokens unreachable
    assert list(TT.unreachable({b"a": 0, b"ab": 1})) == [b"ab"]


def test_engine_audit_runs_once(monkeypatch):
    from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine
    from tokendagger_tpu_torch import engine as TE

    calls = []
    monkeypatch.setattr(TE, "all_reachable",
                        lambda r: calls.append(1) or True)
    eng = DeviceEngine(LLAMA4_PATTERN, make_tiny_vocab()[0], {},
                       device="cpu")
    assert calls == []        # construction does not pay for it
    assert eng.all_reachable() and eng.all_reachable()
    assert calls == [1]


def test_sharded_encoder_guards_equal_jax():
    """ShardedTextEncoder raises ValueError where the JAX package's does:
    an engine on the piece path, a vocabulary that is not reachable."""
    from tokendagger_tpu.engine import DeviceEngine as JaxEngine
    from tokendagger_tpu.parallel.mesh import get_mesh as jax_mesh
    from tokendagger_tpu.parallel.sharded_text import (
        ShardedTextEncoder as JaxSharded,
    )
    from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine
    from tokendagger_tpu_torch.parallel.mesh import get_mesh
    from tokendagger_tpu_torch.parallel.sharded_text import (
        ShardedTextEncoder,
    )

    tiny = make_tiny_vocab()[0]
    cases = ((r"\S+|\s+", tiny),                          # piece path
             (LLAMA4_PATTERN, {**tiny, b"zqx": 900}))      # unreachable
    for pattern, ranks in cases:
        with pytest.raises(ValueError):
            JaxSharded(JaxEngine(pattern, ranks, {}), jax_mesh(1))
        eng = DeviceEngine(pattern, ranks, {}, device="cpu")
        with pytest.raises(ValueError):
            ShardedTextEncoder(eng, get_mesh(1, device="cpu"))
    ShardedTextEncoder(DeviceEngine(LLAMA4_PATTERN, tiny, {}, device="cpu"),
                       get_mesh(1, device="cpu"))
