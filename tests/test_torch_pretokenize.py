"""Port of the UTF-8 decode (kernel K9's plain version, ``utf8_decode``,
``starts_to_bytes``) held against the JAX package's functions, exactly:
the Pallas kernel in interpret mode and the jnp decode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokendagger_tpu.ops import pallas_scan as JS
from tokendagger_tpu.ops import pretokenize as JP
from tokendagger_tpu_torch.ops import pretokenize as TP
from torch_port_util import invalid_utf8, multiscript_text


def _edge_bytes(seed: int, n: int) -> np.ndarray:
    """n seeded bytes: multi-script text with stray continuations, 0xF5-0xFF
    leads, 4-byte emoji, random bytes, and truncated 2/3/4-byte sequences
    at the end (the 4-byte one last)."""
    rng = np.random.default_rng(seed)
    text = multiscript_text(rng, n).encode("utf-8")
    bad = invalid_utf8(rng, n // 2)
    noise = rng.integers(0, 256, n // 8).astype(np.uint8).tobytes()
    raw = (text[: n // 2] + bad + noise)[: n - 9]
    raw += b"\xf5\xff\xbf" + b"\xc3" + b"\xe2\x82" + b"\xf0\x9f\x99"
    assert len(raw) == n
    return np.frombuffer(raw, np.uint8).copy()


@pytest.mark.parametrize("n", [8192, 16384])
def test_k9_plain_equals_pallas_kernel(n):
    data = _edge_bytes(n, n)
    want_cp, want_st = JS.utf8_decode_block(jnp.asarray(data), interpret=True)
    got_cp, got_st = TP.utf8_decode_block(torch.from_numpy(data))
    assert got_cp.dtype == got_st.dtype == torch.int32
    assert np.array_equal(np.asarray(want_cp), got_cp.numpy())
    assert np.array_equal(np.asarray(want_st), got_st.numpy())
    # the stray continuation, 0xF8-0xFF lead and truncation cases occur
    assert (data == 0xBF).any() and (data >= 0xF8).any()
    assert int(got_cp.max()) == 0x10FFFF


def test_k9_rows_decode_independently():
    rows = np.stack([_edge_bytes(s, 4096) for s in range(3)])
    got_cp, got_st = TP.utf8_decode_block(torch.from_numpy(rows))
    for r in range(3):
        one_cp, one_st = TP.utf8_decode_block(torch.from_numpy(rows[r]))
        assert torch.equal(got_cp[r], one_cp) and torch.equal(got_st[r],
                                                              one_st)


@pytest.mark.parametrize("case", ["full", "short", "empty", "garbage"])
def test_utf8_decode_equals_jax(case):
    n = 8192
    data = _edge_bytes(7, n)
    nbytes = {"full": n, "short": n - 1000, "empty": 0,
              "garbage": 3001}[case]
    if case != "garbage":
        data[nbytes:] = 0       # the engine zero-pads its windows
    want = JP.utf8_decode(jnp.asarray(data), jnp.int32(nbytes),
                          use_pallas=False)
    got = TP.utf8_decode(torch.from_numpy(data), nbytes)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(np.asarray(w), g.numpy())
    if case == "empty":
        assert int(got[3]) == 0


def test_utf8_decode_batched_equals_rows():
    rows = np.stack([_edge_bytes(s, 4096) for s in range(3)])
    nbytes = np.array([4096, 17, 0], np.int32)
    got = TP.utf8_decode(torch.from_numpy(rows), torch.from_numpy(nbytes))
    for r in range(3):
        one = TP.utf8_decode(torch.from_numpy(rows[r]), int(nbytes[r]))
        for g, w in zip(got, one):
            assert torch.equal(g[r], w)


@pytest.mark.parametrize("nbytes", [8192, 5000, 0])
def test_starts_to_bytes_equals_jax(nbytes):
    n = 8192
    rng = np.random.default_rng(nbytes)
    data = _edge_bytes(nbytes + 1, n)
    starts = rng.random(n) < 0.3
    _, cob, _, _ = JP.utf8_decode(jnp.asarray(data), jnp.int32(nbytes))
    want = JP.starts_to_bytes(jnp.asarray(starts), cob, jnp.asarray(data),
                              jnp.int32(nbytes))
    got = TP.starts_to_bytes(torch.from_numpy(starts),
                             torch.from_numpy(np.array(cob)),
                             torch.from_numpy(data), nbytes)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_k9_wrapper_checks_inputs():
    with pytest.raises(ValueError):
        TP.utf8_decode_block(torch.zeros((2, 3, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        TP.utf8_decode_block(torch.zeros(64, dtype=torch.int32))
