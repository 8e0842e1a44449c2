"""Piece-key compaction (kernel K2+K3), masked compaction (kernel K4), the
window finalize built on it, and compaction with a recorded route (kernels
K5+K6) with its inverse (K7+K8).

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
* ``compact_record`` and ``expand_route`` have the composed contract of
  ``compact_tiles_masked`` + ``degap_record`` and of ``regap_replay`` +
  ``expand_tiles_replay``: compact a mask's elements to a dense prefix,
  then put values computed on that prefix back on the mask's slots. The
  JAX package's route (gapped rows and butterfly take masks) is internal
  to it; the port's route is a (B, N) int32 tensor holding each masked
  element's rank in its row and -1 off the mask. The compaction's scan
  yields it for free, and the expansion is then one gather pass that
  writes every slot (no clearing, no scatter conflicts). A per-slot
  source index (B, cap) would need a scatter and a cleared output.

CUDA tensors run the kernels of ``csrc/compact.cu`` (K2-K4) and
``csrc/route.cu`` (K5-K8); CPU tensors the plain versions below. Key words
are int32 tensors carrying the uint32 bits.
"""

from __future__ import annotations

import ctypes
import threading
from contextlib import contextmanager
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
        outs.append(buf[:, :P].contiguous())
    return outs


def compact_record_plain(arrays, mask: torch.Tensor, *, cap: int,
                         fill: int = 0):
    """Plain torch version of K5+K6 (see ``compact_record``)."""
    B, N = mask.shape
    keep = mask.to(torch.bool)
    rank = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1
    totals = keep.sum(dim=1, dtype=torch.int32)
    route = torch.where(keep, rank, -1).to(torch.int32)
    slot = torch.where(keep & (rank < cap), rank, cap).to(torch.int64)
    outs = []
    for a in arrays:
        buf = torch.full((B, cap + 1), fill, dtype=a.dtype, device=a.device)
        buf.scatter_(1, slot, a)
        outs.append(buf[:, :cap].contiguous())
    return outs, totals, route


def expand_route_plain(dense: torch.Tensor, route: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K7+K8 (see ``expand_route``)."""
    cap = dense.shape[1]
    ok = mask.to(torch.bool) & (route >= 0) & (route < cap)
    idx = torch.where(ok, route, 0).to(torch.int64)
    return torch.where(ok, torch.gather(dense, 1, idx), 0).to(torch.int32)


# ===========================================================================
# Kernels
# ===========================================================================


@lru_cache(maxsize=None)
def _library():
    from .._build import cuda_library

    lib = cuda_library("compact")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.td_piece_keys_status_words.argtypes = [i, i]
    lib.td_piece_keys_status_words.restype = ctypes.c_longlong
    lib.td_compact_piece_keys.argtypes = (
        [vp, i, vp, vp, i, i, i, vp, vp, vp, ctypes.c_uint, vp])
    lib.td_compact_piece_keys.restype = i
    lib.td_compact_status_words.argtypes = [i, i]
    lib.td_compact_status_words.restype = ctypes.c_longlong
    lib.td_compact_by_mask.argtypes = (
        [vp, i, i] + [vp] * 8 + [i, i, vp, vp, ctypes.c_uint, vp])
    lib.td_compact_by_mask.restype = i
    return lib


@lru_cache(maxsize=None)
def _route_library():
    from .._build import cuda_library

    lib = cuda_library("route")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.td_record_status_words.argtypes = [i, i]
    lib.td_record_status_words.restype = ctypes.c_longlong
    lib.td_compact_record.argtypes = (
        [vp, i, i] + [vp] * 8 + [i, i, i, vp, vp, vp, vp, ctypes.c_uint, vp])
    lib.td_compact_record.restype = i
    lib.td_expand_route.argtypes = [vp, vp, vp, i, i, i, vp, vp]
    lib.td_expand_route.restype = i
    return lib


@contextmanager
def _on(dev: torch.device):
    """Makes ``dev`` the current card and yields its current stream: a
    C entry is issued inside, so that its kernel runs on the tensors'
    card and on that card's stream."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream().cuda_stream


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _launch_k2k3(starts, data, nbytes, p_cap: int, packed: bool):
    lib = _library()
    B, N = data.shape
    dev = data.device
    out = torch.empty((6, B, p_cap), dtype=torch.int32, device=dev)
    n_pieces = torch.empty((B,), dtype=torch.int32, device=dev)
    with _on(dev) as stream:
        status, epoch = _status(("K2+K3", dev, stream),
                                lib.td_piece_keys_status_words(B, N))
        rc = lib.td_compact_piece_keys(
            starts.data_ptr(), int(packed), data.data_ptr(),
            nbytes.data_ptr(), B, N, p_cap, out.data_ptr(),
            n_pieces.data_ptr(), status.data_ptr(), epoch, stream)
    _check(rc, "compact_piece_keys")
    compact_piece_keys.launches += 1
    return (*out.unbind(0), n_pieces)


# The tile status words of the look-back kernels (K2+K3, K4, K5+K6), per
# (kernel, device, stream): [int64 tensor, epoch of the last launch]. Each
# buffer is written by one kernel only, and each launch tags its statuses
# with a new epoch, so they are zeroed once, when allocated, and never
# cleared. Launches on one stream run one after another; a launch on
# another stream gets its own words, since one whose statuses another
# overwrote would wait for them forever. Threads may launch on one stream
# (the engine under a thread pool), so the epoch bump and the growth of a
# buffer are made under a module lock: two launches that got one epoch
# could each read the other's statuses as their own.
_STATUS: dict = {}
_STATUS_LOCK = threading.Lock()


def _status(key, words: int) -> tuple[torch.Tensor, int]:
    """The status words of ``key`` (at least ``words``) and a new epoch."""
    with _STATUS_LOCK:
        st = _STATUS.get(key)
        if st is None or st[0].numel() < words:
            st = _STATUS[key] = [
                torch.zeros(max(words, 4096), dtype=torch.int64,
                            device=key[1]),
                0]
        st[1] = st[1] % ((1 << 30) - 1) + 1
        return st[0], st[1]


def _launch_k4(arrays, mask, fill: int):
    lib = _library()
    B, P = mask.shape
    dev = mask.device
    k = len(arrays)
    out = torch.empty((k, B, P), dtype=torch.int32, device=dev)
    ins = [a.data_ptr() for a in arrays] + [None] * (8 - k)
    with _on(dev) as stream:
        status, epoch = _status(("K4", dev, stream),
                                lib.td_compact_status_words(B, P))
        rc = lib.td_compact_by_mask(mask.data_ptr(), B, P, *ins, k, fill,
                                    out.data_ptr(), status.data_ptr(), epoch,
                                    stream)
    _check(rc, "compact_by_mask")
    compact_by_mask.launches += 1
    return list(out.unbind(0))


def _launch_k5k6(arrays, mask, cap: int, fill: int):
    lib = _route_library()
    B, N = mask.shape
    dev = mask.device
    k = len(arrays)
    out = torch.empty((k, B, cap), dtype=torch.int32, device=dev)
    route = torch.empty((B, N), dtype=torch.int32, device=dev)
    totals = torch.empty((B,), dtype=torch.int32, device=dev)
    ins = [a.data_ptr() for a in arrays] + [None] * (8 - k)
    with _on(dev) as stream:
        status, epoch = _status(("K5+K6", dev, stream),
                                lib.td_record_status_words(B, N))
        rc = lib.td_compact_record(mask.data_ptr(), B, N, *ins, k, cap, fill,
                                   out.data_ptr(), route.data_ptr(),
                                   totals.data_ptr(), status.data_ptr(),
                                   epoch, stream)
    _check(rc, "compact_record")
    compact_record.launches += 1
    return list(out.unbind(0)), totals, route


def _launch_k7k8(dense, route, mask):
    lib = _route_library()
    B, N = mask.shape
    out = torch.empty((B, N), dtype=torch.int32, device=mask.device)
    with _on(mask.device) as stream:
        rc = lib.td_expand_route(dense.data_ptr(), route.data_ptr(),
                                 mask.data_ptr(), B, N, dense.shape[1],
                                 out.data_ptr(), stream)
    _check(rc, "expand_route")
    expand_route.launches += 1
    return out


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


def _require_mask(mask: torch.Tensor) -> None:
    if mask.dim() != 2 or mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous (B, N) bool tensor")
    B, N = mask.shape
    if not (1 <= B <= 65535 and N >= 1):
        raise ValueError(f"mask shape {(B, N)} out of range")
    if mask.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {mask.device}")


def compact_record(arrays, mask: torch.Tensor, *, cap: int, fill: int = 0):
    """Stable-compact 1-8 (B, N) int32 arrays by the (B, N) bool ``mask``,
    recording the route back.

    Returns (dense, totals, route): the (B, cap) int32 arrays holding each
    row's kept elements in order, ``fill`` beyond the kept count; the (B,)
    int32 kept counts, which exceed ``cap`` when the row overflowed (its
    first ``cap`` kept elements are still exact); and the (B, N) int32
    route, each kept element's rank in its row and -1 elsewhere. CUDA
    tensors run kernel K5+K6, CPU tensors the plain version."""
    _require_mask(mask)
    if not 1 <= len(arrays) <= 8:
        raise ValueError("compact_record takes 1 to 8 arrays")
    if cap < 1:
        raise ValueError("cap must be positive")
    for a in arrays:
        _require(a, "array", mask.shape, torch.int32, mask.device)
    if mask.is_cuda:
        return _launch_k5k6(list(arrays), mask, cap, fill)
    return compact_record_plain(arrays, mask, cap=cap, fill=fill)


compact_record.launches = 0


def expand_route(dense: torch.Tensor, route: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Inverse of ``compact_record``: (B, N) int32 holding
    ``dense[b, route[b, j]]`` on each slot j of ``mask`` whose rank is
    below ``cap = dense.shape[1]``, and 0 on every other slot. CUDA
    tensors run kernel K7+K8, CPU tensors the plain version."""
    _require_mask(mask)
    B, N = mask.shape
    if dense.dim() != 2 or dense.shape[0] != B or dense.shape[1] < 1:
        raise ValueError("dense must be a (B, cap) tensor with cap >= 1")
    _require(dense, "dense", dense.shape, torch.int32, mask.device)
    _require(route, "route", (B, N), torch.int32, mask.device)
    if mask.is_cuda:
        return _launch_k7k8(dense, route, mask)
    return expand_route_plain(dense, route, mask)


expand_route.launches = 0


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
