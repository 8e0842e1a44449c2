"""Port's host side (unicode class table, scanner, HostEngine) held equal
to the JAX package's and to a tiktoken.Encoding built offline from the
same ranks."""

import numpy as np
import pytest
import tiktoken

from tests.conftest import make_tiny_vocab
from tokendagger_tpu import hostengine as JH
from tokendagger_tpu import unicode_tables as JU
from tokendagger_tpu_torch import hostengine as TH
from tokendagger_tpu_torch import unicode_tables as TU
from tokendagger_tpu_torch import vocab as TV
from torch_port_util import ascii_text, prose_text

PATTERNS = {
    "llama4": TV.LLAMA4_PATTERN,
    "nocontract": TV.TEKKEN_PATTERN,
    "cl100k": TV.CL100K_PATTERN,
    "gpt2": TV.GPT2_PATTERN,
}


def test_class_table_equals_jax():
    want_c, want_f = JU.get_tables()
    got_c, got_f = TU.get_tables()
    assert got_c.dtype == want_c.dtype == np.uint8
    assert np.array_equal(want_c, got_c)
    assert set(want_f) == set(got_f)
    for k in want_f:
        assert np.array_equal(np.asarray(want_f[k]), got_f[k]), k
    for name in ("WS", "RN", "LETTER", "NUM", "UC", "LC"):
        assert getattr(TU, name) == getattr(JU, name)


def test_patterns_and_profiles_equal_jax():
    from tokendagger_tpu import vocab as JV

    for name, pat in PATTERNS.items():
        assert TV.classify_pattern(pat) == JV.classify_pattern(pat) == name


def _texts(seed: int):
    rng = np.random.default_rng(seed)
    texts = [ascii_text(rng, 3000), prose_text(rng, 3000),
             "héllo wörld — ÄÖÜ 你好 🙂 x'ſ İi Ⅳⅳ\r\n\t ١٢٣"]
    cps = list(range(0x80, 0x3000, 7)) + list(range(0x1F300, 0x1F400, 3))
    cps += sorted(JU.get_override_cps())[::25]  # the calibrated codepoints
    picks = rng.choice(cps, 600)
    mixed = []
    for cp in picks:
        mixed.append(chr(int(cp)))
        mixed.append(" " if rng.random() < 0.2 else "a'sB1"[int(rng.integers(5))])
    texts.append("".join(mixed))
    return texts


@pytest.mark.parametrize("profile", list(PATTERNS))
def test_host_engine_equals_jax(profile):
    ranks, specials = make_tiny_vocab()
    pat = PATTERNS[profile]
    want = JH.HostEngine(pat, ranks, specials)
    got = TH.HostEngine(pat, ranks, specials)
    for t in _texts(1):
        assert got.split_spans(t) == want.split_spans(t)
        assert got.encode_ordinary(t) == want.encode_ordinary(t)


@pytest.mark.parametrize("profile", list(PATTERNS))
def test_host_engine_equals_tiktoken(profile):
    ranks, specials = make_tiny_vocab()
    pat = PATTERNS[profile]
    tk = tiktoken.Encoding(f"t_{profile}", pat_str=pat,
                           mergeable_ranks=ranks, special_tokens=specials)
    got = TH.HostEngine(pat, ranks, specials)
    for t in _texts(2):
        assert got.encode_ordinary(t) == tk.encode_ordinary(t)


def test_generic_pattern_uses_regex():
    ranks, specials = make_tiny_vocab()
    pat = r"\w+|\s+|[^\w\s]+"
    got = TH.HostEngine(pat, ranks, specials)
    want = JH.HostEngine(pat, ranks, specials)
    assert got._scan_profile is None
    t = "hello, world!! it's 42 \t\n done"
    assert got.split(t) == want.split(t)
    assert got.encode_ordinary(t) == want.encode_ordinary(t)


def test_byte_pair_merge_equals_jax():
    ranks, _ = make_tiny_vocab()
    rng = np.random.default_rng(3)
    for _ in range(200):
        piece = bytes(rng.integers(0, 256, int(rng.integers(1, 40))))
        piece = piece if rng.random() < 0.5 else b"hellothere and the"[
            : int(rng.integers(1, 18))]
        assert TH.byte_pair_encode(piece, ranks) == JH.byte_pair_encode(
            piece, ranks)
