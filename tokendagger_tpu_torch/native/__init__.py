"""Native host engine loader: the port's copy of the JAX package's
``native/__init__.py``.

``tdnative.cpp`` is compiled with g++ at first use into the package's
``_build/`` directory (``_build.native_build``: named by a hash of the
sources, the flags and the CPU's features, OpenMP where the toolchain has
it) and loaded with ctypes.
``tdpy.cpp`` is compiled with it into a CPython extension that builds
result lists directly; where that cannot build (a machine without
``Python.h``) the ctypes library alone serves, and without a C++
toolchain ``get_lib()`` is None and callers keep the pure-Python
``HostEngine``. Every call releases the GIL (ctypes does so inherently,
the extension explicitly), so a thread pool over it scales across cores.

Thread-safety: all engine tables (class bitmask, fold ids, pair rows,
byte ranks, vocab hash) are written once during construction and read
only afterwards; scan/encode entry points allocate no shared state. The
only mutable native state is the per-thread piece-memo cache
(``thread_local`` in tdnative.cpp), so concurrent calls need no lock.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import sysconfig
import threading
from pathlib import Path

import numpy as np

from .._build import native_build

_SRC = Path(__file__).with_name("tdnative.cpp")
_PYSRC = Path(__file__).with_name("tdpy.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False
_PYMOD = None
_PYMOD_FAILED = False


def _build() -> Path | None:
    return native_build("tdnative", (_SRC,), timeout=120)


def _build_pymod() -> Path | None:
    """The CPython extension variant (tdnative + tdpy in one .so)."""
    inc = sysconfig.get_paths()["include"]
    return native_build("tdpy", (_SRC, _PYSRC), ("-pthread", f"-I{inc}"))


def get_pymod():
    """The CPython extension module (fast list-returning binding), or None."""
    global _PYMOD, _PYMOD_FAILED
    if _PYMOD is not None or _PYMOD_FAILED:
        return _PYMOD
    with _LOCK:
        if _PYMOD is not None or _PYMOD_FAILED:
            return _PYMOD
        path = _build_pymod()
        if path is None:
            _PYMOD_FAILED = True
            return None
        try:
            spec = importlib.util.spec_from_file_location("tdpy", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _PYMOD = mod
        except Exception:  # noqa: BLE001 - an unloadable build: ctypes only
            _PYMOD_FAILED = True
            return None
        return _PYMOD


def get_lib() -> ctypes.CDLL | None:
    """The ctypes library of tdnative.cpp, or None without a toolchain."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        path = _build()
        if path is None:
            _LIB_FAILED = True
            return None
        lib = ctypes.CDLL(str(path))
        p, i64, i32, i = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                          ctypes.c_int)
        lib.td_create.restype = p
        # classes, fold, pair_rows, nbuckets, mask, byte_rank, profile
        lib.td_create.argtypes = [p, p, p, i64, i32, p, i]
        lib.td_destroy.argtypes = [p]
        lib.td_scan.restype = i64
        lib.td_scan.argtypes = [p, p, i64, p, i64]
        lib.td_encode.restype = i64
        lib.td_encode.argtypes = [p, p, i64, p, i64]
        lib.td_set_vocab.argtypes = [p, p, p, p, p, i64]
        lib.td_set_specials.argtypes = [p, p, p, p, p, i64]
        # engine, data, n, positions (int64*), ids (int32*), byte lengths
        # (int32*), cap
        lib.td_find_specials_l.restype = i64
        lib.td_find_specials_l.argtypes = [p, p, i64, p, p, p, i64]
        lib.td_splice.restype = i64
        # engine, data, n, ids (int64*), n_ids, miss starts and lengths
        # (int32*), n_ms, sentinel, out (int64*), cap, n_whole (int64*),
        # n_han (int64*), nthreads
        lib.td_splice.argtypes = [p, p, i64, p, i64, p, p, i64, i64, p, i64,
                                  p, p, i]
        lib.td_encode_batch.restype = i64
        lib.td_encode_batch.argtypes = [p, p, p, i64, p, p, i]
        lib.td_decode.restype = i64
        # ids (int64*), n, offsets (int64*), lengths (int32*), blob,
        # n_vocab, out (None for the count pass), out_cap, nthreads
        lib.td_decode.argtypes = [p, i64, p, p, p, i64, p, i64, i]
        _LIB = lib
        return _LIB


def binding() -> str:
    """Which host engine this process runs: "extension" (the CPython
    extension over the native engine), "ctypes" (the native engine alone)
    or "python" (no toolchain: ``HostEngine``)."""
    if get_lib() is None:
        return "python"
    return "extension" if get_pymod() is not None else "ctypes"


def decode_ids(ids, offsets, lengths, blob, nthreads: int = 0) -> bytes:
    """ids (int64 ndarray) -> concatenated token bytes via td_decode
    (two-call protocol: validate+count, then GIL-free OpenMP fill).
    Raises KeyError on an unknown id (message-identical to the numpy
    path); returns None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(ids.shape[0])
    nt = nthreads or min(4, os.cpu_count() or 1)
    total = lib.td_decode(
        ids.ctypes.data, n, offsets.ctypes.data, lengths.ctypes.data,
        blob.ctypes.data, int(lengths.shape[0]), None, 0, nt,
    )
    if total < 0:
        raise KeyError(f"Unknown token id: {int(ids[-total - 1])}")
    if total == 0:
        return b""
    # the fill pass re-reads `ids` but revalidates and clamps against
    # `total` in C, so a caller mutating the array between the calls
    # cannot overflow `out`
    out = ctypes.create_string_buffer(int(total))
    lib.td_decode(
        ids.ctypes.data, n, offsets.ctypes.data, lengths.ctypes.data,
        blob.ctypes.data, int(lengths.shape[0]), out, int(total), nt,
    )
    return out.raw


def decode_list(tokens, offsets, lengths, blob, nthreads: int = 0):
    """Python list/tuple of ids -> bytes via the tdpy CPython extension
    (no numpy conversion; GIL-free parallel fill). Returns None when the
    extension is unavailable; raises KeyError on an unknown id."""
    mod = get_pymod()
    if mod is None or not hasattr(mod, "decode_list"):
        return None
    nt = nthreads or min(4, os.cpu_count() or 1)
    return mod.decode_list(
        tokens, memoryview(offsets), memoryview(lengths),
        memoryview(blob), int(lengths.shape[0]), nt,
    )


def _install_vocab(lib, h, ranks: dict[bytes, int]):
    """Install ``ranks`` as engine ``h``'s whole-piece vocab hash (the fast
    path for a piece that is one token, also the merge's span-rank
    table); returns the (blob, offsets, lengths, ranks) arrays the engine
    borrows, which the caller keeps alive. The packed slot layout caps
    token length at 255 bytes and blob offsets at 24 bits: beyond that
    the engine cannot be exact, so this raises RuntimeError (the caller
    keeps the Python engine)."""
    keys = list(ranks.keys())
    if any(len(k) > 255 for k in keys):
        raise RuntimeError("vocab has tokens > 255 bytes")
    if sum(len(k) for k in keys) > (1 << 24):
        raise RuntimeError("vocab blob exceeds 16 MB")
    blob, offs, lens = _blob_table(keys)
    vranks = np.fromiter((ranks[k] for k in keys), dtype=np.int32,
                         count=len(keys))
    lib.td_set_vocab(h, blob.ctypes.data, offs.ctypes.data,
                     lens.ctypes.data, vranks.ctypes.data, len(keys))
    return blob, offs, lens, vranks


def _blob_table(keys: list[bytes]):
    """(blob uint8, offsets int64, lengths int32) of byte strings."""
    blob = np.frombuffer(b"".join(keys), dtype=np.uint8)
    lens = np.fromiter((len(k) for k in keys), dtype=np.int32,
                       count=len(keys))
    offs = np.zeros(len(keys), dtype=np.int64)
    offs[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    return blob, offs, lens


class _SpecialScan:
    """The byte-space special-token scan of a native engine handle
    ``self._h`` (``td_set_specials``, ``td_find_specials_l``):
    ``HostEngine.find_all_specials``' selection over the whole installed
    set, exact on valid UTF-8 (lead and continuation bytes differ, and a
    same-position tie's shorter token is a byte prefix of the longer)."""

    _sp_ok = False

    def set_specials(self, specials: dict[str, int]) -> bool:
        """Install ``specials`` (text -> id) as the scan table. Returns
        False when the set is empty or not installable (a token empty or
        over 255 bytes, or 16 MB of them): the caller keeps a Python
        scan."""
        self._sp_ok = False
        if not specials:
            return False
        keys = [s.encode("utf-8") for s in specials]
        if any(not k or len(k) > 255 for k in keys):
            return False
        if sum(len(k) for k in keys) > (1 << 24):
            return False
        # borrowed by the C side: kept alive here
        self._sp_blob, self._sp_offs, self._sp_lens = _blob_table(keys)
        self._sp_ids = np.fromiter(
            (specials[s] for s in specials), dtype=np.int32, count=len(keys)
        )
        self._lib.td_set_specials(
            self._h, self._sp_blob.ctypes.data, self._sp_offs.ctypes.data,
            self._sp_lens.ctypes.data, self._sp_ids.ctypes.data, len(keys),
        )
        self._sp_ok = True
        return True

    def find_specials_l(self, data: bytes):
        """(byte_pos int64, id int32, byte length int32) arrays of every
        installed special's occurrence in ``data``, in order. None =>
        caller falls back (no table installed)."""
        if not self._sp_ok:
            return None
        n = len(data)
        cap = 1024
        while True:
            # one buffer for the three arrays (positions, then ids and
            # lengths as int32): a short text's call pays one allocation
            # and one pointer read
            buf = np.empty(2 * cap, np.int64)
            p = buf.ctypes.data
            cnt = self._lib.td_find_specials_l(
                self._h, data, n, p, p + 8 * cap, p + 12 * cap, cap
            )
            if cnt == -3:
                return None
            if cnt >= 0:
                tail = buf[cap:].view(np.int32)
                return buf[:cnt], tail[:cnt], tail[cap : cap + cnt]
            cap *= 8  # -1: capacity overflow; worst case one match/byte
            if cap > 8 * n + 1024:
                cap = n + 1


class NativeEngine(_SpecialScan):
    """Native scan+merge over one vocab. Thread-safe (stateless calls)."""

    # scanner profile ids (must match the C++ Profile enum)
    _PROFILES = {"nocontract": 0, "llama4": 1, "cl100k": 2, "gpt2": 3,
                 "kimi": 4}

    def __init__(
        self,
        pair_rows: np.ndarray,
        pair_mask: int,
        byte_rank: np.ndarray,
        *,
        contractions: bool = True,
        profile: str | None = None,
        ranks: dict[bytes, int] | None = None,
    ):
        from ..scanner_ref import _fold_id_table
        from ..unicode_tables import get_tables, kimi_classes

        if profile is None:
            profile = "llama4" if contractions else "nocontract"
        profile_id = self._PROFILES[profile]
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        # kimi reads its own table: Han without UC or LC, and the HAN bit
        classes = kimi_classes() if profile == "kimi" else get_tables()[0]
        # keep referenced: the C side borrows these buffers
        self._classes = np.ascontiguousarray(classes, dtype=np.uint8)
        self._fold = np.ascontiguousarray(_fold_id_table(), dtype=np.int8)
        self._pair_rows = np.ascontiguousarray(pair_rows, dtype=np.int32)
        self._byte_rank = np.ascontiguousarray(byte_rank, dtype=np.int32)
        self._h = lib.td_create(
            self._classes.ctypes.data,
            self._fold.ctypes.data,
            self._pair_rows.ctypes.data,
            self._pair_rows.shape[0],
            pair_mask,
            self._byte_rank.ctypes.data,
            profile_id,
        )
        if not self._h:
            raise RuntimeError("td_create failed")
        if ranks:
            (self._vocab_blob, self._vocab_offs, self._vocab_lens,
             self._vocab_ranks) = _install_vocab(lib, self._h, ranks)

        # optional CPython-extension binding: GIL-free encode that builds
        # the result list directly (no numpy -> tolist pass)
        self._py = None
        self._py_cap = None
        mod = get_pymod()
        if mod is not None:
            try:
                self._py_cap = mod.create(
                    self._classes, self._fold, self._pair_rows,
                    self._pair_rows.shape[0], pair_mask, self._byte_rank,
                    profile_id,
                )
                if ranks:
                    mod.set_vocab(
                        self._py_cap, self._vocab_blob, self._vocab_offs,
                        self._vocab_lens, self._vocab_ranks, len(ranks),
                    )
                    # shared immortal PyLongs for every possible ordinary
                    # id: list materialization then allocates nothing per
                    # token (tdpy.cpp prime_longs)
                    if hasattr(mod, "prime_longs"):
                        mod.prime_longs(int(self._vocab_ranks.max()) + 1)
                self._py = mod
            except Exception:  # noqa: BLE001 - keep the ctypes engine
                self._py = None

    @property
    def binding(self) -> str:
        """"extension" or "ctypes": which binding serves the list calls."""
        return "extension" if self._py is not None else "ctypes"

    def set_specials(self, specials: dict[str, int]) -> bool:
        """Install the native special-token scan table (the single-pass
        byte-space scanner behind find_specials_l), on the ctypes engine and
        on the extension's. Returns False when the set is empty or not
        installable (the caller keeps the Python scan)."""
        if not super().set_specials(specials):
            return False
        if self._py is not None and hasattr(self._py, "set_specials"):
            # the CPython-extension binding runs its own engine instance
            self._py.set_specials(
                self._py_cap, self._sp_blob, self._sp_offs, self._sp_lens,
                self._sp_ids, len(self._sp_ids),
            )
        return True

    def encode_with_specials(self, data: bytes, num_threads: int = 4):
        """Full-allowed-set encode of one text in ONE extension call:
        native special scan + GIL-free OpenMP encode of every ordinary
        segment + interleaved list materialization (special-dense chat
        text has ~30k tiny segments per MB; per-segment calls pay µs
        each). None => caller falls back."""
        if (self._py is None or not self._sp_ok
                or not hasattr(self._py, "encode_with_specials")):
            return None
        return self._py.encode_with_specials(self._py_cap, data,
                                             num_threads)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.td_destroy(h)
            self._h = None

    def scan(self, data: bytes) -> np.ndarray:
        """Piece start byte offsets (with end sentinel appended)."""
        n = len(data)
        starts = np.empty(n + 1, dtype=np.int32)
        cnt = self._lib.td_scan(
            self._h, data, n, starts.ctypes.data, n + 1
        )
        if cnt < 0:
            raise RuntimeError("td_scan capacity error")
        return starts[: cnt + 1]

    def encode(self, data: bytes) -> np.ndarray | None:
        """Ordinary-encode one segment. None => caller must fall back."""
        n = len(data)
        if n == 0:
            return np.empty(0, dtype=np.int32)
        out = np.empty(n, dtype=np.int32)
        cnt = self._lib.td_encode(self._h, data, n, out.ctypes.data, n)
        if cnt == -2:
            return None  # vocab lacks single-byte ranks
        if cnt < 0:
            raise RuntimeError("td_encode capacity error")
        return out[:cnt]

    def encode_list(self, data: bytes) -> list | None:
        """Ordinary-encode one segment returning a Python list directly
        (CPython-extension path). None => caller must fall back."""
        if self._py is None:
            return None
        if not data:
            return []
        return self._py.encode_list(self._py_cap, data)

    def encode_batch_lists(
        self, datas: list[bytes], num_threads: int = 8
    ) -> list[list[int]] | None:
        """Batch-encode segments into Python lists in one extension call:
        GIL-free OpenMP encode of every text, then a single materialization
        pass from the shared PyLong cache. None => caller must fall back."""
        if self._py is None or not hasattr(self._py, "encode_batch_lists"):
            return None
        if not datas:
            return []
        return self.encode_slices_lists(b"".join(datas), _offsets(datas),
                                        num_threads)

    def encode_slices_lists(
        self, blob: bytes, offs: np.ndarray, num_threads: int = 8
    ) -> list[list[int]] | None:
        """Like encode_batch_lists but over slices of ONE byte blob given
        by an int64 offsets array (len == n_slices + 1): no per-chunk
        copies, no re-join. The wrapper's intra-text split path
        (``Tokenizer._encode_split_parallel``) uses it."""
        if self._py is None or not hasattr(self._py, "encode_batch_lists"):
            return None
        n = len(offs) - 1
        if n <= 0:
            return []
        return self._py.encode_batch_lists(
            self._py_cap, blob, np.ascontiguousarray(offs, dtype=np.int64),
            n, num_threads,
        )

    def encode_batch(
        self, datas: list[bytes], num_threads: int = 8
    ) -> list[np.ndarray] | None:
        """Batch-encode segments in one GIL-free native call (OpenMP fan-out
        in C++, no Python thread pool). None => caller must fall back."""
        n_texts = len(datas)
        if n_texts == 0:
            return []
        offs = _offsets(datas)
        blob = b"".join(datas)
        out = np.empty(max(1, offs[-1]), dtype=np.int32)
        counts = np.zeros(n_texts, dtype=np.int64)
        err = self._lib.td_encode_batch(
            self._h, blob, offs.ctypes.data, n_texts,
            out.ctypes.data, counts.ctypes.data, num_threads,
        )
        if err == -2:
            return None
        if err < 0:
            raise RuntimeError(f"td_encode_batch error {err}")
        return [
            out[offs[i] : offs[i] + counts[i]] for i in range(n_texts)
        ]


# td_splice's codes for a splice it leaves to the plain route
SPLICE_RANKLESS = -2
SPLICE_MISCOUNT = -3


class NativeSplicer(_SpecialScan):
    """The native splice of a device window's missed pieces (``td_splice``)
    over a vocab-only engine: the whole-piece hash and the byte-pair LUT,
    which are all its merge reads, and the kimi class table, whose HAN bit
    counts the misses that start with a Han char; no pair table.
    Raises RuntimeError without a toolchain or for a vocabulary the
    engine cannot hold (``_install_vocab``). Thread-safe, as
    ``NativeEngine`` is. A window of at least 1,024 misses resolves them
    on ``threads`` threads. Its handle also holds the device engine's
    special-token scan, once ``set_specials`` installs it."""

    def __init__(self, ranks: dict[bytes, int], byte_rank: np.ndarray):
        from ..unicode_tables import kimi_classes

        self.threads = min(8, os.cpu_count() or 1)
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._byte_rank = np.ascontiguousarray(byte_rank, dtype=np.int32)
        self._classes = kimi_classes()  # borrowed by the C side
        self._h = lib.td_create(self._classes.ctypes.data, None, None, 0, 0,
                                self._byte_rank.ctypes.data, 0)
        if not self._h:
            raise RuntimeError("td_create failed")
        self._vocab = _install_vocab(lib, self._h, ranks)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.td_destroy(h)
            self._h = None

    def splice(self, ids: np.ndarray, data: bytes, ms_s: np.ndarray,
               ms_l: np.ndarray, n_ms: int, sentinel: int):
        """(ids with each ``sentinel`` replaced by the ids of its miss,
        the misses found whole in the vocab, the misses whose first char
        is Han): ``ids`` int64 in piece order, miss j the piece
        ``data[ms_s[j] : ms_s[j] + ms_l[j]]``. Where it cannot splice
        natively, the code: ``SPLICE_RANKLESS`` (a byte has no rank) or
        ``SPLICE_MISCOUNT`` (the sentinels are not ``n_ms``), for the
        caller's plain route (``splice.Splicer``)."""
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        ms_s = np.ascontiguousarray(ms_s[:n_ms], dtype=np.int32)
        ms_l = np.ascontiguousarray(ms_l[:n_ms], dtype=np.int32)
        cap = len(ids) - n_ms + int(ms_l.sum(dtype=np.int64))
        out = np.empty(max(cap, 0), dtype=np.int64)
        whole = ctypes.c_int64(0)
        han = ctypes.c_int64(0)
        cnt = self._lib.td_splice(
            self._h, data, len(data), ids.ctypes.data, len(ids),
            ms_s.ctypes.data, ms_l.ctypes.data, n_ms, sentinel,
            out.ctypes.data, len(out), ctypes.byref(whole),
            ctypes.byref(han), self.threads)
        if cnt in (SPLICE_RANKLESS, SPLICE_MISCOUNT):
            return int(cnt)
        if cnt < 0:
            raise RuntimeError(f"td_splice error {cnt}")
        return out[:cnt], whole.value, han.value


def _offsets(datas: list[bytes]) -> np.ndarray:
    """(n + 1,) int64 start offsets of ``datas`` joined, with the end."""
    offs = np.zeros(len(datas) + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(d) for d in datas), dtype=np.int64,
                          count=len(datas)), out=offs[1:])
    return offs
