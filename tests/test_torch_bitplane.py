"""Port of ops/bitplane (kernel K1's plain versions, ASCII and codepoint,
and the host build of its derivation) held against the JAX package's
Pallas kernel in interpret mode, its char-level derivations and
scanner_ref, bit for bit."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokendagger_tpu.ops import bitplane as JB
from tokendagger_tpu.ops import pretokenize as JP
from tokendagger_tpu.scanner_ref import piece_starts as ref_piece_starts
from tokendagger_tpu.unicode_tables import get_two_level_tables
from tokendagger_tpu_torch.ops import bitplane as TB
from tokendagger_tpu_torch.scanner_ref import piece_starts as port_piece_starts
from tokendagger_tpu_torch.unicode_tables import char_class_words
from torch_port_util import ascii_text, multiscript_text, stage

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


# ---------------------------------------------------------------------------
# General text: codepoint windows (K1's codepoint entry)
# ---------------------------------------------------------------------------

NC = 1 << 13


@pytest.mark.parametrize("profile", PROFILES)
def test_class_words_ascii_equal_class_lut(profile):
    words = char_class_words(profile)
    assert words.shape == (0x110000,) and words.dtype == np.uint16
    assert np.array_equal(words[:128].astype(np.uint32), TB.class_lut(profile))


def _cp_windows(seed: int):
    """(B, NC) int32 codepoint windows of multi-script text (fold letters
    after apostrophes, U+3000, emoji, CJK, ...) with garbage codepoints
    beyond each length, and the (B,) lengths."""
    rng = np.random.default_rng(seed)
    texts = [multiscript_text(rng, NC), multiscript_text(rng, NC - 333), "",
             "\u3000", "x'\u017f I'\u212a 'ſ'ſ \u3000\u3000a Ωmega ǅ " * 40]
    cp = rng.integers(0, 0x110000, (len(texts), NC)).astype(np.int32)
    m = np.zeros(len(texts), np.int32)
    for b, t in enumerate(texts):
        c = np.array([ord(ch) for ch in t[:NC]], np.int32)
        cp[b, : len(c)] = c
        m[b] = len(c)
    return cp, m


@pytest.mark.parametrize("profile", PROFILES)
def test_piece_starts_chars_equals_jax(two_level, profile):
    cp, m = _cp_windows(5)
    got = TB.piece_starts_chars(torch.from_numpy(cp), torch.from_numpy(m),
                                profile=profile).numpy()
    for b in range(cp.shape[0]):
        # the engine's CPU form (char-per-element) sees a 0-padded window
        padded = np.where(np.arange(NC) < m[b], cp[b], 0)
        want = np.asarray(JP._piece_starts_j(
            jnp.asarray(padded), jnp.int32(m[b]), *two_level,
            contractions=profile != "nocontract", profile=profile))
        assert np.array_equal(want, got[b]), (profile, b)
        want_bits = np.asarray(JB.piece_starts_bits(
            jnp.asarray(cp[b]), jnp.int32(m[b]), *two_level,
            profile=profile, ascii_fast=False))
        assert np.array_equal(want_bits, got[b]), (profile, b)
    # one window in, one window out
    one = TB.piece_starts_chars(torch.from_numpy(cp[0]), int(m[0]),
                                profile=profile)
    assert np.array_equal(one.numpy(), got[0])


def _host_kernel_cp(cp, m, profile):
    from tokendagger_tpu_torch._build import host_library

    lib = host_library("piece_starts_host")
    vp = ctypes.c_void_p
    lib.td_piece_starts_cp_host.argtypes = [vp, vp, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, vp, vp]
    lib.td_piece_starts_cp_host.restype = ctypes.c_int
    B, n = cp.shape
    out = np.zeros((B, n // 32), np.uint32)
    table = char_class_words(profile)
    passes = lib.td_piece_starts_cp_host(
        cp.ctypes.data, m.ctypes.data, B, n, TB._PROFILE_ID[profile],
        table.ctypes.data, out.ctypes.data)
    return out.view(np.int32), passes


@pytest.mark.parametrize("profile", PROFILES)
def test_kernel_derivation_host_build_codepoints_equals_plain(profile):
    """The codepoint entry of the derivation the CUDA kernel runs, built
    for the host, equals the plain version (including codepoints outside
    [0, 0x10FFFF], which have no class)."""
    cp, m = _cp_windows(6)
    cp[0, 7] = 0x7FFFFFFF
    cp[0, 11] = -5
    got, passes = _host_kernel_cp(cp, m, profile)
    assert passes > 0, "kernel scratch planes exhausted"
    want = TB.piece_starts_chars(torch.from_numpy(cp), torch.from_numpy(m),
                                 profile=profile, packed_out=True)
    assert np.array_equal(want.numpy(), got)


def test_piece_starts_chars_checks_inputs():
    cp = torch.zeros((1, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        TB.piece_starts_chars(cp.to(torch.int64), 3)
    with pytest.raises(ValueError):
        TB.piece_starts_chars(torch.zeros((1, 1000), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        TB.piece_starts_chars(cp, torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        TB.piece_starts_chars(cp, 3, profile="p50k")


# ---------------------------------------------------------------------------
# Hot-codepoint class lookup and K1's class-word entry (the general
# pipeline's starts under the auto capacity)
# ---------------------------------------------------------------------------

C_HOT = 32768
HOT_POOL = (0x20, 0x200D, 0xFE0F, 0x1F3FB, ord("a"), ord("!"), 0x65E5,
            0x1F600, 0x301, 0x41F, ord("'"), 0x017F)


def _hot_windows(seed: int):
    """(2, C_HOT) codepoints, 80% from HOT_POOL and the rest random below
    0x2FFFF, 0 beyond each length (as the decode pads them)."""
    rng = np.random.default_rng(seed)
    cp = np.zeros((2, C_HOT), np.int32)
    m = np.array([C_HOT - 1234, C_HOT // 2 + 77], np.int32)
    for b in range(2):
        pool = rng.choice(np.array(HOT_POOL), m[b])
        rand = rng.integers(1, 0x2FFFF, m[b])
        cp[b, : m[b]] = np.where(rng.random(m[b]) < 0.8, pool, rand)
    return cp, m


def test_class_lookup_hot_equals_jax(two_level):
    cp, m = _hot_windows(7)
    hot = HOT_POOL
    want, want_ovf = JB.class_lookup_hot(
        jnp.asarray(cp), jnp.asarray(m), *two_level, hot_cps=hot,
        u_cap=C_HOT // 2, interpret=True)
    got, ovf = TB.class_lookup_hot(torch.from_numpy(cp), torch.from_numpy(m),
                                   hot_cps=hot, u_cap=C_HOT // 2)
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want_ovf), ovf.numpy())
    assert not ovf.any()
    want = np.asarray(want)
    for b in range(2):
        assert np.array_equal(want[b, : m[b]], got[b, : m[b]].numpy()), b
    # an undersized u_cap raises the flag on both
    _, w2 = JB.class_lookup_hot(jnp.asarray(cp), jnp.asarray(m), *two_level,
                                hot_cps=(0x200D,), u_cap=4096, interpret=True)
    _, g2 = TB.class_lookup_hot(torch.from_numpy(cp), torch.from_numpy(m),
                                hot_cps=(0x200D,), u_cap=4096)
    assert np.array_equal(np.asarray(w2), g2.numpy()) and g2.all()


@pytest.mark.parametrize("profile", PROFILES)
def test_piece_starts_chars_hot_equals_jax(two_level, profile):
    cp, m = _hot_windows(8)
    hot, u_cap = HOT_POOL, 8192
    want, want_ovf = JB.piece_starts_bits_pallas(
        jnp.asarray(cp), jnp.asarray(m), *two_level, profile=profile,
        hot_cps=hot, u_cap=u_cap, interpret=True)
    got, ovf = TB.piece_starts_chars(torch.from_numpy(cp),
                                     torch.from_numpy(m), profile=profile,
                                     hot_cps=hot, u_cap=u_cap)
    assert np.array_equal(np.asarray(want_ovf), ovf.numpy())
    assert not ovf.any()
    assert np.array_equal(np.asarray(want), got.numpy())
    # the same flags as the codepoint entry without the hot route
    plain = TB.piece_starts_chars(torch.from_numpy(cp), torch.from_numpy(m),
                                  profile=profile)
    assert torch.equal(plain, got)


def _host_kernel_words(words, m, profile):
    from tokendagger_tpu_torch._build import host_library

    lib = host_library("piece_starts_host")
    vp = ctypes.c_void_p
    lib.td_piece_starts_words_host.argtypes = [vp, vp, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int, vp]
    lib.td_piece_starts_words_host.restype = ctypes.c_int
    B, n = words.shape
    out = np.zeros((B, n // 32), np.uint32)
    passes = lib.td_piece_starts_words_host(
        words.ctypes.data, m.ctypes.data, B, n, TB._PROFILE_ID[profile],
        out.ctypes.data)
    return out.view(np.int32), passes


@pytest.mark.parametrize("profile", PROFILES)
def test_kernel_derivation_host_build_words_equals_plain(profile):
    """K1's class-word entry, built for the host, equals its plain version
    and the codepoint entry on the same windows (garbage words beyond
    each length)."""
    cp, m = _cp_windows(9)
    cls, _ = TB.class_lookup_hot(torch.from_numpy(cp), torch.from_numpy(m),
                                 hot_cps=(32, 97, 0x3000), u_cap=NC,
                                 table=char_class_words(profile))
    words = cls.numpy().copy()
    rng = np.random.default_rng(10)
    for b in range(words.shape[0]):
        words[b, m[b]:] = rng.integers(0, 1 << 16, NC - m[b])
    got, passes = _host_kernel_words(words, m, profile)
    assert passes > 0, "kernel scratch planes exhausted"
    want = TB.piece_starts_words(torch.from_numpy(words), torch.from_numpy(m),
                                 profile=profile)
    assert np.array_equal(want.numpy(), got)
    cp_entry = TB.piece_starts_chars(torch.from_numpy(cp), torch.from_numpy(m),
                                     profile=profile, packed_out=True)
    assert np.array_equal(cp_entry.numpy(), got)


def test_piece_starts_words_checks_inputs():
    w = torch.zeros((1, 1024), dtype=torch.int32)
    m = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        TB.piece_starts_words(w.to(torch.int16), m)
    with pytest.raises(ValueError):
        TB.piece_starts_words(w[:, :1000].contiguous(), m)
    with pytest.raises(ValueError):
        TB.piece_starts_words(w, m.to(torch.int64))
    with pytest.raises(ValueError):
        TB.piece_starts_chars(w, 3, hot_cps=(32,))
