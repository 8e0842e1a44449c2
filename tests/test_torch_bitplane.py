"""Port of ops/bitplane (kernel K1's plain version and the host build of
its derivation) held against the JAX package's Pallas kernel in
interpret mode and against scanner_ref, bit for bit."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokendagger_tpu.ops import bitplane as JB
from tokendagger_tpu.scanner_ref import piece_starts as ref_piece_starts
from tokendagger_tpu.unicode_tables import get_two_level_tables
from tokendagger_tpu_torch.ops import bitplane as TB
from tokendagger_tpu_torch.scanner_ref import piece_starts as port_piece_starts
from torch_port_util import ascii_text, stage

PROFILES = ["llama4", "nocontract", "cl100k", "gpt2"]
N = 1 << 15


def _windows(seed: int):
    rng = np.random.default_rng(seed)
    texts = [ascii_text(rng, N - 321), ascii_text(rng, N + 100), "",
             "x", "it's  WON'T I'll 123,456 a//b \r\n\t  Zz0 " * 3]
    return stage(texts, N, rng)


@pytest.fixture(scope="module")
def two_level():
    return tuple(jnp.asarray(t) for t in get_two_level_tables())


def _plain(by, nb, profile, packed_out=True):
    return TB.piece_starts_bits(torch.from_numpy(by), torch.from_numpy(nb),
                                profile=profile, packed_out=packed_out)


@pytest.mark.parametrize("profile", PROFILES)
def test_plain_equals_pallas_kernel(two_level, profile):
    by, nb = _windows(1)
    want = np.asarray(JB.piece_starts_bits_pallas(
        jnp.asarray(by), jnp.asarray(nb), *two_level, profile=profile,
        ascii_fast=True, packed_out=True, interpret=True))
    got = _plain(by, nb, profile).numpy()
    assert np.array_equal(want.view(np.int32), got)
    # packed_out=False is the same flags unpacked
    flags = _plain(by, nb, profile, packed_out=False).numpy()
    assert np.array_equal(np.asarray(JB.jax.vmap(JB.unpack_mask)(
        jnp.asarray(want))), flags)


@pytest.mark.parametrize("profile", PROFILES)
def test_plain_equals_scanner_ref(profile):
    by, nb = _windows(2)
    flags = _plain(by, nb, profile, packed_out=False).numpy()
    for b in range(by.shape[0]):
        m = int(nb[b])
        cp = by[b, :m].astype(np.int64)
        want = ref_piece_starts(cp, profile=profile)
        assert np.array_equal(want, flags[b, :m]), (profile, b)
        assert np.array_equal(port_piece_starts(cp, profile=profile), want)
        assert not flags[b, m:].any()


def _host_kernel(by, nb, profile):
    from tokendagger_tpu_torch._build import host_library

    lib = host_library("piece_starts_host")
    vp = ctypes.c_void_p
    lib.td_piece_starts_host.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, vp, vp]
    lib.td_piece_starts_host.restype = ctypes.c_int
    B, n = by.shape
    out = np.zeros((B, n // 32), np.uint32)
    lut = TB.class_lut(profile)
    passes = lib.td_piece_starts_host(
        by.ctypes.data, nb.ctypes.data, B, n, TB._PROFILE_ID[profile],
        lut.ctypes.data, out.ctypes.data)
    return out.view(np.int32), passes


@pytest.mark.parametrize("profile", PROFILES)
def test_kernel_derivation_host_build_equals_plain(profile):
    """The derivation source the CUDA kernel runs (csrc/starts_derive.cuh),
    built for the host, equals the plain version."""
    by, nb = _windows(3)
    got, passes = _host_kernel(by, nb, profile)
    assert passes > 0, "kernel scratch planes exhausted"
    assert np.array_equal(_plain(by, nb, profile).numpy(), got)


@pytest.mark.parametrize("m", [0, 1, 31, 32, 33, 1000, 1023, 1024])
def test_kernel_derivation_host_build_short_windows(m):
    rng = np.random.default_rng(m)
    by, nb = stage([ascii_text(rng, m)], 1024, rng)
    for profile in PROFILES:
        got, _ = _host_kernel(by, nb, profile)
        assert np.array_equal(_plain(by, nb, profile).numpy(), got), profile


@pytest.mark.parametrize("n", [32, 64, 96, 4096])
def test_pack_roundtrip_matches_jax(n):
    rng = np.random.default_rng(n)
    mask = rng.random((2, n)) < 0.3
    got = TB.pack_mask(torch.from_numpy(mask)).numpy()
    want = np.stack([np.asarray(JB.pack_mask(jnp.asarray(r))) for r in mask])
    assert np.array_equal(want.view(np.int32), got)
    assert np.array_equal(TB.unpack_mask(torch.from_numpy(got)).numpy(), mask)


@pytest.mark.parametrize("k", [1, 2, 3, 31, 32, 33, 100, 1023, 1024, 5000])
def test_shifts_match_jax(k):
    rng = np.random.default_rng(k)
    w = rng.integers(0, 2**32, (2, 64), dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(w.view(np.int32))
    for fn_t, fn_j in ((TB.prevk, JB.prevk), (TB.nxtk, JB.nxtk)):
        want = np.asarray(fn_j(jnp.asarray(w), k)).view(np.int32)
        assert np.array_equal(want, fn_t(t, k).numpy()), fn_t.__name__


@pytest.mark.parametrize("density", [0.02, 0.3, 0.9])
def test_scans_match_jax(density):
    rng = np.random.default_rng(int(density * 100))
    x = rng.random((2, 2048)) < density
    r = rng.random((2, 2048)) < 0.1
    xw = np.stack([np.asarray(JB.pack_mask(jnp.asarray(v))) for v in x])
    rw = np.stack([np.asarray(JB.pack_mask(jnp.asarray(v))) for v in r])
    xt, rt = (torch.from_numpy(a.view(np.int32)) for a in (xw, rw))
    xj, rj = jnp.asarray(xw), jnp.asarray(rw)
    pairs = [
        (TB.seg_or_fwd(xt, rt), JB.seg_or_fwd(xj, rj)),
        (TB.seg_or_rev(xt, rt), JB.seg_or_rev(xj, rj)),
        (TB.or_scan_fwd(xt), JB.or_scan_fwd(xj)),
        (TB.xor_scan_fwd(xt), JB.xor_scan_fwd(xj)),
        (TB.ffill_bool(rt, xt), JB.ffill_bool(rj, xj)),
        (TB.stride_marks(xt & rt, xt, 3, 2048),
         JB.stride_marks(xj & rj, xj, 3, 2048)),
    ]
    for i, (got, want) in enumerate(pairs):
        assert np.array_equal(np.asarray(want).view(np.int32),
                              got.numpy()), i


def test_wrapper_checks_inputs():
    by = torch.zeros((1, 1024), dtype=torch.uint8)
    nb = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        TB.piece_starts_bits(by.to(torch.int32), nb)
    with pytest.raises(ValueError):
        TB.piece_starts_bits(torch.zeros((1, 1000), dtype=torch.uint8), nb)
    with pytest.raises(ValueError):
        TB.piece_starts_bits(by, nb.to(torch.int64))
    with pytest.raises(NotImplementedError):
        TB.piece_starts_bits(by, nb, profile="p50k")
