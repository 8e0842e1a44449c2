"""``run_resident``'s batched combinations other than the general and the
fused ASCII pipelines (``impl`` "scatter", "sort", "ascii-sort" with
``starts_impl`` "jnp" or "bits" and ``compact_impl`` "sort", the ASCII
butterfly compaction behind char-form starts, and the butterfly's
degrade to "sort" off ASCII), on the CPU, each against the host engine
and against a JAX ``run_resident`` call. For the sort compaction the
JAX package's "jnp" and "bits" starts give the same flags (its own
tests hold them equal), so one JAX call per ``impl``, with "jnp", serves
both; the butterfly cases call it on identical arguments."""

import numpy as np
import pytest

from tests.conftest import make_tiny_vocab
from tokendagger_tpu.resident import run_resident as jax_run_resident
from tokendagger_tpu_torch import LLAMA4_PATTERN, run_resident
from torch_port_util import multiscript_text, prose_text

W = 1 << 15
COMPARED = ("impl", "match_host", "total_tokens", "cap_bpp", "probe_impl",
            "probe_hot", "overflow_windows", "compact_impl")
TEXT = {"scatter": "multiscript", "sort": "multiscript",
        "ascii-sort": "ascii"}


@pytest.fixture(scope="module")
def corpora():
    return {"multiscript": multiscript_text(np.random.default_rng(2),
                                            3 * W).encode(),
            "ascii": prose_text(np.random.default_rng(3), 3 * W).encode()}


def _kw(impl, **kw):
    return dict(window=W, n_windows=2, batch=2, reps=1, overlap_trial=False,
                impl=impl, **kw)


@pytest.fixture(scope="module")
def jax_runs(corpora):
    """One JAX run per (text, impl, other arguments), made on first use."""
    ranks, specials = make_tiny_vocab()
    runs = {}

    def get(text, impl, **kw):
        key = (text, impl, *sorted(kw.items()))
        if key not in runs:
            runs[key] = jax_run_resident(ranks, specials, LLAMA4_PATTERN,
                                         corpora[text], **_kw(impl, **kw))
        return runs[key]

    return get


def _same(got, want):
    assert want.match_host and got.match_host
    for f in COMPARED:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("impl", ["scatter", "sort", "ascii-sort"])
@pytest.mark.parametrize("starts_impl", ["jnp", "bits"])
def test_batched_combination_equals_jax(corpora, jax_runs, impl,
                                        starts_impl):
    ranks, specials = make_tiny_vocab()
    got = run_resident(ranks, specials, LLAMA4_PATTERN, corpora[TEXT[impl]],
                       device="cpu", starts_impl=starts_impl, **_kw(impl))
    _same(got, jax_runs(TEXT[impl], impl))
    assert got.starts_impl == starts_impl and got.compact_impl == "sort"
    assert got.batch == 2


@pytest.mark.parametrize("starts_impl", ["jnp", "bits"])
def test_ascii_butterfly_behind_char_starts(corpora, jax_runs,
                                           starts_impl):
    """ascii-sort with the butterfly compaction but not the fused starts:
    K2+K3 and compact.finalize take the char-form (or K1) flags, which
    are byte flags on ASCII."""
    ranks, specials = make_tiny_vocab()
    kw = dict(starts_impl=starts_impl, compact_impl="butterfly")
    r = run_resident(ranks, specials, LLAMA4_PATTERN, corpora["ascii"],
                     device="cpu", **kw, **_kw("ascii-sort"))
    fused = run_resident(ranks, specials, LLAMA4_PATTERN, corpora["ascii"],
                         device="cpu", starts_impl="bits-pallas",
                         compact_impl="butterfly", **_kw("ascii-sort"))
    _same(r, jax_runs("ascii", "ascii-sort", **kw))
    assert r.compact_impl == "butterfly"
    assert r.total_tokens == fused.total_tokens


def test_butterfly_falls_back_to_sort_off_ascii(corpora, jax_runs):
    ranks, specials = make_tiny_vocab()
    r = run_resident(ranks, specials, LLAMA4_PATTERN, corpora["multiscript"],
                     device="cpu", compact_impl="butterfly", **_kw("sort"))
    _same(r, jax_runs("multiscript", "sort", compact_impl="butterfly"))
    assert r.compact_impl == "sort"
