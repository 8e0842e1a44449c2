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
