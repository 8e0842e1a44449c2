"""UTF-8 decode (kernel K9) and the char <-> byte mappings of a window.

Counterparts of the JAX package's ``ops/pretokenize`` (``utf8_decode``,
``starts_to_bytes``) and ``ops/pallas_scan`` (``utf8_decode_block``):

* ``utf8_decode_block`` gives, per byte, the codepoint assembled from it
  and its next three bytes and the lead-byte flag. CUDA tensors run kernel
  K9 (``csrc/utf8.cu``); CPU tensors the plain version below.
* ``utf8_decode`` compacts those to one codepoint per char: K9, a
  ``torch.cumsum`` for the char index of every byte, and kernel K4
  (``compact.compact_by_mask``) for the compaction the JAX function does
  with two scatters.
* ``starts_to_bytes`` maps char-level piece-start flags to byte flags.
* ``utf8_decode_tiles`` and ``expand_starts_replay`` are the batched
  general pipeline's decode and its inverse (the JAX functions of those
  names): the codepoints of the lead bytes compacted to a dense (B, c_cap)
  prefix by kernel K5+K6 (``compact.compact_record``), with the route that
  K7+K8 (``compact.expand_route``) follows to put char-level piece-start
  flags back on the lead bytes.

``utf8_decode``, ``utf8_decode_block`` and ``starts_to_bytes`` take a
(B, N) batch of windows with (B,) int32 lengths, or one (N,) window with a
scalar length, as the JAX functions do; the general pipeline's functions
take batches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .compact import (
    _check, _on, _require, compact_by_mask, compact_record, expand_route,
)

MAX_CP = 0x10FFFF


def _batched(data: torch.Tensor, nbytes):
    """(B, N) view of ``data`` and (B,) int32 lengths on its device, and
    whether the caller passed one window."""
    one = data.dim() == 1
    nb = torch.as_tensor(nbytes, device=data.device).to(torch.int32)
    if one:
        return data[None], nb.reshape(1), True
    return data, nb.reshape(-1), False


# ===========================================================================
# K9: per-byte decode
# ===========================================================================


def _next_bytes(b: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = b[..., i + k], 0 past the end of the row."""
    pad = torch.zeros(b.shape[:-1] + (k,), dtype=b.dtype, device=b.device)
    return torch.cat([b[..., k:], pad], dim=-1)


def utf8_decode_block_plain(data: torch.Tensor):
    """Plain torch version of K9: (..., N) uint8 -> (cp_at, is_start),
    both (..., N) int32 (the jnp branch of the JAX ``utf8_decode``)."""
    b = data.to(torch.int32)
    b1, b2, b3 = (_next_bytes(b, k) for k in (1, 2, 3))
    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = (((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
           | (b3 & 0x3F))
    cp_at = torch.where(b < 0x80, b, torch.where(
        b < 0xE0, cp2, torch.where(b < 0xF0, cp3, cp4)))
    is_start = ((b & 0xC0) != 0x80).to(torch.int32)
    return torch.clamp(cp_at, 0, MAX_CP), is_start


@lru_cache(maxsize=None)
def _k9_library():
    from .._build import cuda_library

    lib = cuda_library("utf8")
    vp = ctypes.c_void_p
    lib.td_utf8_decode_block.argtypes = [vp, ctypes.c_int, ctypes.c_longlong,
                                         vp, vp, vp]
    lib.td_utf8_decode_block.restype = ctypes.c_int
    return lib


def _launch_k9(data: torch.Tensor):
    lib = _k9_library()
    B, N = data.shape
    cp_at = torch.empty((B, N), dtype=torch.int32, device=data.device)
    is_start = torch.empty((B, N), dtype=torch.int32, device=data.device)
    with _on(data.device) as stream:
        rc = lib.td_utf8_decode_block(data.data_ptr(), B, N,
                                      cp_at.data_ptr(), is_start.data_ptr(),
                                      stream)
    _check(rc, "utf8_decode_block")
    utf8_decode_block.launches += 1
    return cp_at, is_start


def utf8_decode_block(data: torch.Tensor):
    """Per-byte (codepoint at the byte, lead flag) of (N,) or (B, N) uint8
    windows, both int32 of the same shape. Each row decodes on its own:
    neighbours past its end read as 0. Any N (the Pallas kernel needed
    N % 8192 == 0). CUDA tensors run kernel K9; CPU tensors the plain
    version."""
    if data.dim() not in (1, 2):
        raise ValueError("data must be (N,) or (B, N)")
    d2 = data if data.dim() == 2 else data[None]
    _require(d2, "data", d2.shape, torch.uint8, data.device)
    if data.is_cuda:
        out = _launch_k9(d2)
    elif data.device.type == "cpu":
        out = utf8_decode_block_plain(d2)
    else:
        raise ValueError(f"unsupported device {data.device}")
    return out if data.dim() == 2 else tuple(o[0] for o in out)


utf8_decode_block.launches = 0


# ===========================================================================
# Compaction to chars and the byte mapping
# ===========================================================================


def utf8_decode(data: torch.Tensor, nbytes):
    """Decode UTF-8 windows to compacted codepoints.

    ``data`` (N,) or (B, N) uint8 (anything at or beyond ``nbytes``),
    ``nbytes`` a scalar or (B,) int32. Returns (cp int32 0-padded,
    char_of_byte int32 = cumsum(lead) - 1, byte_of_char int32 padded with
    nbytes, n_chars int32 (0 when nbytes == 0)), shapes as the input's:
    the contract of the JAX ``utf8_decode``."""
    d, nb, one = _batched(data, nbytes)
    B, N = d.shape
    cp_at, lead = utf8_decode_block(d)
    idx = torch.arange(N, dtype=torch.int32, device=d.device)
    is_start = (lead != 0) & (idx < nb[:, None])
    char_of_byte = torch.cumsum(is_start, dim=1, dtype=torch.int32) - 1
    n_chars = torch.where(nb > 0, torch.clamp(char_of_byte[:, -1] + 1, min=0),
                          0).to(torch.int32)
    cp, boc = compact_by_mask(
        [cp_at, idx.expand(B, N).contiguous()], is_start, fill=0)
    byte_of_char = torch.where(idx < n_chars[:, None], boc, nb[:, None])
    out = (cp, char_of_byte, byte_of_char, n_chars)
    return tuple(o[0] for o in out) if one else out


def starts_to_bytes(starts_char: torch.Tensor, char_of_byte: torch.Tensor,
                    data: torch.Tensor, nbytes) -> torch.Tensor:
    """Byte-level piece-start flags: byte j starts a piece iff it is a
    lead byte below ``nbytes`` and its char's flag is set."""
    d, nb, one = _batched(data, nbytes)
    sc = starts_char if not one else starts_char[None]
    cob = char_of_byte if not one else char_of_byte[None]
    N = d.shape[1]
    idx = torch.arange(N, device=d.device)
    is_lead = ((d.to(torch.int32) & 0xC0) != 0x80) & (idx < nb[:, None])
    out = torch.gather(sc, 1, cob.clamp(0, N - 1).to(torch.int64)) & is_lead
    return out[0] if one else out


# ===========================================================================
# The batched general pipeline's decode and its inverse
# ===========================================================================


def utf8_codepoints_at_leads(data: torch.Tensor, nbytes: torch.Tensor):
    """Per-byte codepoint (valid at lead bytes; K9) and the (B, N) bool
    mask of the lead bytes below ``nbytes``: the JAX
    ``_utf8_codepoints_at_leads``."""
    cp_at, is_start = utf8_decode_block(data)
    idx = torch.arange(data.shape[1], dtype=torch.int32, device=data.device)
    return cp_at, (is_start != 0) & (idx < nbytes[:, None])


def utf8_decode_tiles(data: torch.Tensor, nbytes: torch.Tensor, *,
                      c_cap: int | None = None):
    """General UTF-8 decode of a window batch with its route.

    ``data`` (B, N) uint8, ``nbytes`` (B,) int32. Returns (cp (B, c_cap)
    int32, the codepoints of the lead bytes in order and 0 at and beyond
    ``n_chars``; lead (B, N) bool; n_chars (B,) int32, which exceeds
    ``c_cap`` when the window has more chars; route, for
    ``expand_starts_replay``): the JAX ``utf8_decode_tiles``."""
    d, nb, _ = _batched(data, nbytes)
    C = c_cap or d.shape[1]
    cp_at, lead = utf8_codepoints_at_leads(d, nb)
    (cp,), n_chars, route = compact_record([cp_at], lead, cap=C, fill=0)
    return cp, lead, n_chars, route


def expand_starts_replay(starts_char: torch.Tensor, lead: torch.Tensor,
                         route: torch.Tensor) -> torch.Tensor:
    """Byte-level piece-start flags from char-level ones: byte j's flag is
    ``lead[j] & starts_char[rank(j)]`` (0 for a char past ``c_cap``), with
    ``rank`` and ``route`` from ``utf8_decode_tiles``."""
    flags = expand_route(starts_char.to(torch.int32).contiguous(), route,
                         lead)
    return flags != 0
