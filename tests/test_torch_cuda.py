"""The port's CUDA kernels against their plain torch versions on the card,
at small shapes. Needs a card: every test here is marked ``cuda`` and
skips without one. On the card (no JAX there) run

    TD_REAL_BACKEND=1 python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from tokendagger_tpu_torch.ops import bitplane as BP
from tokendagger_tpu_torch.ops import compact as CP
from tokendagger_tpu_torch.ops import pretokenize as PT
from torch_port_util import (
    ascii_text, invalid_utf8, multiscript_text, prose_text, stage,
)

pytestmark = pytest.mark.cuda
PROFILES = ["llama4", "nocontract", "cl100k", "gpt2"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _windows(seed, n, dev):
    rng = np.random.default_rng(seed)
    texts = [ascii_text(rng, n), prose_text(rng, n - 77), "", "a" * n,
             "! " * (n // 2), "x"]
    by, nb = stage(texts, n, rng)
    return torch.from_numpy(by).to(dev), torch.from_numpy(nb).to(dev)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n", [1024, 1 << 15])
def test_k1_equals_plain(dev, profile, n):
    by, nb = _windows(n, n, dev)
    got = BP.piece_starts_bits(by, nb, profile=profile)
    want = BP.piece_starts_bits_plain(by, nb, profile=profile)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_k2k3_equals_plain(dev, packed):
    n = 1 << 15
    by, nb = _windows(3, n, dev)
    words = BP.piece_starts_bits(by, nb)
    flags = words if packed else BP.unpack_mask(words)
    p_cap = n // 3 // 128 * 128
    got = CP.compact_piece_keys(flags, by, nb, p_cap, packed=packed)
    want = CP.compact_piece_keys_plain(flags, by, nb, p_cap, packed=packed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[6].max()) > p_cap  # the overflow window


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("P", [100, 8192, 20001])
def test_k4_equals_plain(dev, k, P):
    g = torch.Generator(device=dev).manual_seed(P + k)
    arrays = [torch.randint(-2**31, 2**31 - 1, (3, P), generator=g,
                            device=dev, dtype=torch.int32) for _ in range(k)]
    mask = torch.rand((3, P), generator=g, device=dev) < 0.3
    mask[1] = False
    mask[2] = True
    for fill in (0, -1):
        got = CP.compact_by_mask(arrays, mask, fill=fill)
        want = CP.compact_by_mask_plain(arrays, mask, fill=fill)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_stream_card_equals_cpu(dev):
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, ResidentStream

    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(9)
    corpus = (prose_text(rng, 5 * 32768) + " é " + "! " * 20000).encode()
    outs = []
    for d in ("cuda", "cpu"):
        rs = ResidentStream(ranks, specials, LLAMA4_PATTERN, window=1 << 15,
                            batch=2, device=d)
        outs.append(rs.encode(corpus))
    (a, sa), (b, sb) = outs
    assert a == b
    assert sa.host_fallback_windows == sb.host_fallback_windows >= 1
    assert sa.spliced_pieces == sb.spliced_pieces


def _utf8_windows(seed, n, dev):
    rng = np.random.default_rng(seed)
    raws = [multiscript_text(rng, n).encode()[:n], invalid_utf8(rng, n),
            b"", "\U0001f642".encode() * (n // 4), b"\xff" * n,
            prose_text(rng, n).encode()]
    by = rng.integers(0, 256, (len(raws), n)).astype(np.uint8)
    nb = np.zeros(len(raws), np.int32)
    for b, raw in enumerate(raws):
        by[b, : len(raw)] = np.frombuffer(raw, np.uint8)
        nb[b] = len(raw)
    return torch.from_numpy(by).to(dev), torch.from_numpy(nb).to(dev)


@pytest.mark.parametrize("n", [1000, 8192, 1 << 16])
def test_k9_equals_plain(dev, n):
    by, nb = _utf8_windows(n, n, dev)
    got = PT.utf8_decode_block(by)
    want = PT.utf8_decode_block_plain(by)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the decode around it: card == CPU
    on_card = PT.utf8_decode(by, nb)
    on_cpu = PT.utf8_decode(by.cpu(), nb.cpu())
    for g, w in zip(on_card, on_cpu):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n", [1024, 1 << 15])
def test_k1_codepoints_equals_plain(dev, profile, n):
    by, nb = _utf8_windows(n + 1, n, dev)
    cp, _, _, m = PT.utf8_decode(by, nb)
    cp[1, 5] = 0x7FFFFFFF            # out-of-range codepoints have no class
    cp[1, 9] = -3
    got = BP.piece_starts_chars(cp, m, profile=profile, packed_out=True)
    want = BP.piece_starts_chars_plain(cp, m, profile=profile)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_engine_card_equals_cpu(dev):
    from conftest import make_tiny_vocab
    from tokendagger_tpu_torch import LLAMA4_PATTERN, DeviceEngine, Tokenizer

    ranks, specials = make_tiny_vocab()
    rng = np.random.default_rng(11)
    text = multiscript_text(rng, 40000) + " " * 70000 + "a " * 30000
    engines = [DeviceEngine(LLAMA4_PATTERN, ranks, specials, device=d)
               for d in ("cuda", "cpu")]
    engines[0]._window = 1 << 16       # start as small as the CPU's
    a, b = (e.encode_stream(text.encode()) for e in engines)
    assert a.tolist() == b.tolist()
    # the space run grows the card's window; the CPU's cannot grow and
    # takes the host route
    assert engines[0].stats.grown_windows >= 1
    assert engines[1].stats.host_advance_windows >= 1
    tok = Tokenizer("t", pat_str=LLAMA4_PATTERN, mergeable_ranks=ranks,
                    special_tokens=specials, device="cuda")
    sample = text[:20000] + "<|bos|>" + text[:3000]
    ids = tok.encode(sample, allowed_special="all")
    assert ids == engines[1].host.encode(sample, tok.special_tokens_set)[0]
    assert tok.decode(ids) == sample
