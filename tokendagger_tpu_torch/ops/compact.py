"""Piece-key compaction (kernel K2+K3), masked compaction (kernel K4) and
the window finalize built on it.

Counterparts of the JAX package's ``ops/compact_pallas``:

* ``compact_piece_keys`` has the contract of
  ``compact_piece_keys_butterfly``: from byte-level start flags (bool, or
  the plane-major words of ``bitplane.piece_starts_bits``) it returns
  ``(start_b, piece_len, k0, k1, k2, k3, n_pieces)`` — each piece's start,
  its length (next start minus start; the last kept piece ends at
  ``nbytes``), its first 16 bytes as four little-endian key words masked
  to its length, and the live count, which exceeds ``p_cap`` on overflow.
  Dead slots hold ``start_b = nbytes``, length 0, keys 0.
* ``compact_by_mask`` stably compacts int32 arrays by a mask, ``fill``
  beyond the kept count.
* ``finalize`` returns the 9-tuple of ``finalize_butterfly``.

CUDA tensors run the kernels of ``csrc/compact.cu``; CPU tensors the plain
versions below. Key words are int32 tensors carrying the uint32 bits.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .bitplane import unpack_mask
from .fused import SENTINEL
from .join import sliding_words, to_i32


# ===========================================================================
# Plain versions
# ===========================================================================


def compact_piece_keys_plain(starts, data, nbytes, p_cap: int, *,
                             packed: bool = False):
    """Plain torch version of K2+K3 (see module doc)."""
    B, N = data.shape
    dev = data.device
    nb = nbytes.to(torch.int64)[:, None]
    idx = torch.arange(N, device=dev)
    flags = unpack_mask(starts) if packed else starts.to(torch.bool)
    live = flags & (idx < nb)
    n_pieces = live.sum(dim=1)
    rank = torch.cumsum(live, dim=1) - 1
    slot = torch.where(live & (rank < p_cap), rank, p_cap)
    buf = torch.zeros((B, p_cap + 1), dtype=torch.int64, device=dev)
    buf.scatter_(1, slot, idx.expand(B, N))
    kept = torch.clamp(n_pieces, max=p_cap)[:, None]
    pslot = torch.arange(p_cap, device=dev)
    is_live = pslot < kept
    start_b = torch.where(is_live, buf[:, :p_cap], nb)
    nxt = torch.cat([start_b[:, 1:], nb], dim=1)
    end_b = torch.where(pslot + 1 < kept, nxt, nb)
    piece_len = torch.where(is_live, end_b - start_b, 0)
    at = start_b.clamp(max=N - 1)
    keys = []
    for j, w in enumerate(sliding_words(data, nbytes)):
        r = torch.clamp(piece_len - 4 * j, 0, 4)
        m = torch.where(r >= 4, 0xFFFFFFFF, (1 << (8 * r.clamp(max=3))) - 1)
        keys.append(to_i32(torch.gather(w, 1, at) & m))
    return (start_b.to(torch.int32), piece_len.to(torch.int32), *keys,
            n_pieces.to(torch.int32))


def compact_by_mask_plain(arrays, mask: torch.Tensor, *, fill: int = 0):
    """Plain torch version of K4."""
    B, P = mask.shape
    keep = mask.to(torch.bool)
    rank = torch.cumsum(keep, dim=1) - 1
    slot = torch.where(keep, rank, P)
    outs = []
    for a in arrays:
        buf = torch.full((B, P + 1), fill, dtype=a.dtype, device=a.device)
        buf.scatter_(1, slot, a)
        outs.append(buf[:, :P])
    return outs


# ===========================================================================
# Kernels
# ===========================================================================


@lru_cache(maxsize=None)
def _library():
    from .._build import cuda_library

    lib = cuda_library("compact")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.td_compact_tiles.argtypes = [i]
    lib.td_compact_tiles.restype = i
    lib.td_compact_piece_keys.argtypes = [vp, i, vp, vp, i, i, i] + [vp] * 9
    lib.td_compact_piece_keys.restype = i
    lib.td_compact_by_mask.argtypes = [
        vp, i, i, ctypes.POINTER(vp), ctypes.POINTER(vp), i, i, vp, vp]
    lib.td_compact_by_mask.restype = i
    return lib


def _stream(dev: torch.device) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _launch_k2k3(starts, data, nbytes, p_cap: int, packed: bool):
    lib = _library()
    B, N = data.shape
    dev = data.device
    counts = torch.empty((B, lib.td_compact_tiles(N)), dtype=torch.int32,
                         device=dev)
    outs = [torch.empty((B, p_cap), dtype=torch.int32, device=dev)
            for _ in range(6)]
    n_pieces = torch.empty((B,), dtype=torch.int32, device=dev)
    rc = lib.td_compact_piece_keys(
        starts.data_ptr(), int(packed), data.data_ptr(), nbytes.data_ptr(),
        B, N, p_cap, counts.data_ptr(), *[o.data_ptr() for o in outs],
        n_pieces.data_ptr(), _stream(dev))
    _check(rc, "compact_piece_keys")
    compact_piece_keys.launches += 1
    return (*outs, n_pieces)


def _launch_k4(arrays, mask, fill: int):
    lib = _library()
    B, P = mask.shape
    dev = mask.device
    counts = torch.empty((B, lib.td_compact_tiles(P)), dtype=torch.int32,
                         device=dev)
    outs = [torch.empty_like(a) for a in arrays]
    k = len(arrays)
    ins_p = (ctypes.c_void_p * k)(*[a.data_ptr() for a in arrays])
    outs_p = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    rc = lib.td_compact_by_mask(mask.data_ptr(), B, P, ins_p, outs_p, k,
                                fill, counts.data_ptr(), _stream(dev))
    _check(rc, "compact_by_mask")
    compact_by_mask.launches += 1
    return outs


def _require(t: torch.Tensor, name: str, shape, dtype, dev) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"{dtype} tensor on {dev}")


# ===========================================================================
# Public functions
# ===========================================================================


def compact_piece_keys(starts: torch.Tensor, data: torch.Tensor,
                       nbytes: torch.Tensor, p_cap: int, *,
                       packed: bool = False):
    """Per-piece (start_b, piece_len, k0..k3, n_pieces) of a window batch.

    ``starts`` (B, N) bool/uint8 byte flags, or with ``packed`` the
    (B, N/32) int32 plane-major words of ``piece_starts_bits`` (N a
    multiple of 1024); ``data`` (B, N) uint8; ``nbytes`` (B,) int32."""
    if data.dim() != 2:
        raise ValueError("data must be (B, N)")
    B, N = data.shape
    dev = data.device
    _require(data, "data", (B, N), torch.uint8, dev)
    _require(nbytes, "nbytes", (B,), torch.int32, dev)
    if packed:
        if N % 1024:
            raise ValueError(f"packed flags need N % 1024 == 0, got {N}")
        _require(starts, "starts", (B, N // 32), torch.int32, dev)
    elif starts.dtype == torch.bool:
        _require(starts, "starts", (B, N), torch.bool, dev)
    else:
        _require(starts, "starts", (B, N), torch.uint8, dev)
    if p_cap < 1:
        raise ValueError("p_cap must be positive")
    if dev.type == "cuda":
        if not packed and N % 32:
            raise ValueError(f"byte flags need N % 32 == 0, got {N}")
        return _launch_k2k3(starts, data, nbytes, p_cap, packed)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return compact_piece_keys_plain(starts, data, nbytes, p_cap,
                                    packed=packed)


compact_piece_keys.launches = 0


def compact_by_mask(arrays, mask: torch.Tensor, *, fill: int = 0):
    """Stable-compact each (B, P) int32 array of ``arrays`` by the (B, P)
    bool ``mask``; slots beyond the kept count get ``fill``."""
    if mask.dim() != 2 or mask.dtype != torch.bool:
        raise ValueError("mask must be a (B, P) bool tensor")
    dev = mask.device
    if not 1 <= len(arrays) <= 8:
        raise ValueError("compact_by_mask takes 1 to 8 arrays")
    _require(mask, "mask", mask.shape, torch.bool, dev)
    for a in arrays:
        _require(a, "array", mask.shape, torch.int32, dev)
    if dev.type == "cuda":
        return _launch_k4(list(arrays), mask, fill)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return compact_by_mask_plain(arrays, mask, fill=fill)


compact_by_mask.launches = 0


def finalize(start_b, piece_len, rank, n_pieces, *, p_cap: int):
    """Flat ids of complete windows, SENTINEL where the probe missed:
    (flat, n_kept, n_pieces, n_kept, consumed, overflow, miss_start,
    miss_len, n_miss) as ``finalize_butterfly`` returns them."""
    dev = start_b.device
    pslot = torch.arange(p_cap, device=dev)[None, :]
    n_kept = torch.clamp(n_pieces, max=p_cap)
    live = pslot < n_kept[:, None]
    end_b = start_b + piece_len
    consumed = torch.where(live, end_b, 0).amax(dim=1).to(torch.int32)
    overflow = n_pieces > p_cap
    hit = live & (rank >= 0)
    miss = live & (rank < 0)
    flat = torch.where(live, torch.where(hit, rank, SENTINEL), -1)
    n_ms = miss.sum(dim=1).to(torch.int32)
    ms_s, ms_l = compact_by_mask([start_b, piece_len], miss, fill=0)
    return (flat.to(torch.int32), n_kept, n_pieces, n_kept, consumed,
            overflow, ms_s, ms_l, n_ms)
