"""tiktoken-compatible public API of the port.

``Tokenizer`` (and the ``Encoding``/``create_tokenizer``/``load_tokenizer``
factories) is the port's own copy of the JAX package's ``wrapper.py``
surface. Backends:

* ``"device"`` (the default) encodes through ``engine.DeviceEngine`` on
  ``device`` (default ``"cuda"``; ``"cpu"`` runs every kernel's plain
  version) and decodes large id lists there with ``ops/decode.decode_ids``;
* ``"host"`` uses the native C++ host engine (``native/``: built with g++
  at first use, its CPython extension or its ctypes library) and, without
  a C++ toolchain or for a pattern outside the five profiles, the exact
  pure-Python ``hostengine.HostEngine``; ``host_binding`` says which;
* ``"auto"`` weighs the device against the host engine as the JAX
  package's wrapper does: inputs under ``_DEVICE_MIN_BYTES`` stay on the
  host; with a native engine, only inputs of at least
  ``_DEVICE_AUTO_MIN_BYTES`` go to the device, and only while its
  measured dispatch time (``_device_dispatch_ms``) is under
  ``_DEVICE_HEALTHY_MS``; without one, the rest go to the device.

``DeviceEngine`` serves every tokenizer: a pattern of the five profiles
with a rank for every single byte takes its stream path, any other its
piece path (a host split, then the device BPE merge). Decoding needs
only the rank -> bytes tables. With ``"device"`` or ``"auto"`` and no card,
construction raises; a device or kernel failure raises too and is never
rerouted to the host. Every entry point raises what the JAX package's
raises: ``encode`` lets ``ValueError`` through and wraps the rest in
``TokenDaggerError``, the batch entry points wrap nothing. All engines emit
the same ids.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import AbstractSet, Collection, Literal, Sequence

import numpy as np
import torch

from .convert import (
    EngineTables, decode_tables_from_ranks, engine_tables_from_ranks,
)
from . import native as _native
from .engine import DeviceEngine
from .hostengine import HostEngine, byte_pair_merge
from .tables import build_decode_tables, build_pair_table, byte_rank
from .utils.profiling import span
from .vocab import classify_pattern, vocab_list_to_ranks

_BACKENDS = ("device", "host", "auto")


class TokenDaggerError(Exception):
    """Base exception of the public API."""


class Tokenizer:
    """High-level tokenizer with a tiktoken-compatible API.

    Args: ``pattern``/``pat_str``, ``vocab``/``mergeable_ranks``,
    ``special_tokens``, ``vocab_file``, ``special_tokens_file``, plus
    ``backend`` ("device", "host" or "auto", see the module doc),
    ``device`` for the device engine and ``tables``, prebuilt
    ``EngineTables`` on that device (``convert.engine_tables_from_ranks``
    or ``engine_tables_from_reference``).
    """

    def __init__(
        self,
        name: str,
        *,
        pattern: str | None = None,
        pat_str: str | None = None,
        vocab: list[dict] | dict[bytes, int] | None = None,
        mergeable_ranks: dict[bytes, int] | None = None,
        special_tokens: dict[str, int] | None = None,
        vocab_file: str | Path | None = None,
        special_tokens_file: str | Path | None = None,
        backend: Literal["device", "host", "auto"] = "device",
        device: str | torch.device = "cuda",
        tables: EngineTables | None = None,
    ):
        self.name = name
        if pat_str is not None:
            pattern = pat_str
        if pattern is None:
            raise ValueError(
                "A split pattern ('pattern' or 'pat_str') is required")
        self.pattern = pattern
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}")
        self.backend = backend
        self.device = torch.device(device)
        if backend != "host":
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"backend={backend!r} on device='cuda' but CUDA is not "
                    "available (pass backend='host' or device='cpu')")
            if self.device.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {self.device}")

        if mergeable_ranks is not None:
            vocab = mergeable_ranks
        if vocab_file:
            with open(Path(vocab_file), "r", encoding="utf-8") as f:
                vocab = json.load(f)
        if vocab is None:
            raise ValueError("Either 'vocab', 'mergeable_ranks', or "
                             "'vocab_file' must be provided")
        ranks = dict(vocab) if isinstance(vocab, dict) else (
            vocab_list_to_ranks(vocab))

        if special_tokens_file:
            with open(Path(special_tokens_file), "r", encoding="utf-8") as f:
                special_tokens = json.load(f)
        if special_tokens is None:
            special_tokens = {}

        self._mergeable_ranks = ranks
        self._special_tokens = dict(special_tokens)
        self.max_token_value = max(
            max(ranks.values()),
            max(special_tokens.values()) if special_tokens else 0,
        )
        try:
            self._host = HostEngine(pattern, ranks, special_tokens)
        except Exception as e:  # noqa: BLE001 - mirror reference error wrapping
            raise TokenDaggerError(f"Failed to initialize engine: {e}") from e

        self._tables = tables
        self._device = None         # DeviceEngine, built on first device use
        self._device_ms = None      # measured dispatch time, lazily (auto)
        self._native = None         # NativeEngine, built lazily
        self._native_tried = False
        self._native_lock = threading.Lock()
        self._host_decode = None    # numpy decode tables, lazily
        self._sp_id_lens = None     # special id -> UTF-8 length, lazily
        self._decode = None         # decode tables on the device, lazily
        self._decode_lengths = None  # numpy copy of their lengths
        self._sorted_bytes = None   # token_byte_values, built lazily
        self._unstable_aux = None   # encode_with_unstable's tables, lazily
        # one DeviceEngine however many threads ask for it first
        self._device_lock = threading.Lock()
        # frozenset identity marks the common "disallow all specials" case
        # so the bigram prefilter groups are computed once
        self._all_specials_frozen = frozenset(self._special_tokens)
        self._disallowed_all_groups: dict[str, list[str]] | None = None

    # ------------------------------------------------------------------
    # Backend routing
    # ------------------------------------------------------------------
    # The thresholds come from chip_smoke.py's "auto" phase on an NVIDIA
    # H100 80GB HBM3 at 700 W, 8 host cores (walls of one text with
    # specials, encode_batch with specials and encode_ordinary_batch at
    # 1 KB-16 MB; PERF.md §6).
    # "auto" keeps inputs under this many bytes on the host engine: from
    # 16 KB on the device beat the pure-Python HostEngine in three runs
    # for one text and a batch with specials, in two of them for an
    # ordinary batch (from 64 KB in the third); at 4 KB it lost one text
    # (3.08 ms against 2.44).
    _DEVICE_MIN_BYTES = 16384
    # With a native engine, "auto" sends an input to the device only from
    # this many bytes on, and only while the dispatch probe stays under
    # _DEVICE_HEALTHY_MS. In three runs the device beat the native engine
    # at no size of one text (1.1-8.6x slower) nor of an ordinary batch
    # (1.5-7.4x slower, but for a 1% tie at 16 KB once); it won only
    # encode_batch with specials, whose native route splits in Python
    # (1.2-2.2x, from 16 KB or 256 KB). One threshold serves all calls,
    # so: never.
    _DEVICE_AUTO_MIN_BYTES = float("inf")
    # the probe read 0.06-0.12 ms on that card; the threshold is the JAX
    # package's, which parts a co-located card from a remote runtime
    _DEVICE_HEALTHY_MS = 1.0

    def _get_device(self):
        with self._device_lock:
            if self._device is None:
                tables = self._tables
                if tables is None and self._decode is not None:
                    tables = engine_tables_from_ranks(
                        self._mergeable_ranks, self._special_tokens,
                        device=self.device, decode=self._decode)
                self._device = DeviceEngine(
                    self.pattern, self._mergeable_ranks, self._special_tokens,
                    device=self.device, tables=tables)
                self._tables = self._device.tables
            return self._device

    def _get_native(self):
        """The native C++ host engine (``native/tdnative.cpp``): the
        profile scanner, the whole-piece vocab hash and the exact merge
        over the pair table. None for a pattern outside the five profiles,
        without a C++ toolchain, or for a vocabulary it cannot hold
        exactly (a token over 255 bytes)."""
        with self._native_lock:
            if not self._native_tried:
                self._native_tried = True
                kind = classify_pattern(self.pattern)
                if kind is not None:
                    ranks = self._mergeable_ranks
                    try:
                        pair = build_pair_table(ranks)
                        native = _native.NativeEngine(
                            pair.rows, pair.mask, byte_rank(ranks),
                            profile=kind, ranks=ranks)
                    except RuntimeError:  # no toolchain, or refused vocab
                        native = None
                    if native is not None and self._special_tokens:
                        # the single-pass byte-space special scan (exact
                        # find_all_specials selection)
                        native.set_specials(self._special_tokens)
                    self._native = native
            return self._native

    @property
    def host_binding(self) -> str:
        """The host engine this tokenizer runs: "extension" (the native
        engine's CPython extension), "ctypes" (its ctypes library alone)
        or "python" (``HostEngine``)."""
        native = self._get_native()
        return "python" if native is None else native.binding

    def _device_dispatch_ms(self) -> float:
        """The device's dispatch time, measured once: a small kernel
        followed by a read back, after one warm-up read, averaged over 5.
        The device pipeline beats the native host engine only when such
        round trips are cheap. A CPU device is never preferred over the
        native engine (the same silicon, more overhead): inf."""
        if self._device_ms is None:
            if self.device.type != "cuda":
                self._device_ms = float("inf")
            else:
                x = torch.arange(1024, dtype=torch.int32, device=self.device)
                int((x * 3 + 1).sum())  # warm-up and the first read back
                t0 = time.perf_counter()
                for _ in range(5):
                    int((x * 3 + 1).sum())
                self._device_ms = (time.perf_counter() - t0) / 5 * 1e3
        return self._device_ms

    def _use_device(self, nbytes: int) -> bool:
        """The routing of one call, for encode and decode."""
        if self.backend == "host":
            return False
        if self.backend == "device":
            return True
        if nbytes < self._DEVICE_MIN_BYTES:
            return False
        if self._get_native() is not None:
            return (nbytes >= self._DEVICE_AUTO_MIN_BYTES
                    and self._device_dispatch_ms() < self._DEVICE_HEALTHY_MS)
        return True

    @staticmethod
    def _nbytes(texts: Sequence[str]) -> int:
        """Summed UTF-8 byte length of ``texts`` (the unit of the
        thresholds above)."""
        with span("td.utf8"):
            return sum(len(t) if t.isascii() else len(t.encode("utf-8"))
                       for t in texts)

    @staticmethod
    def _effective_threads(num_threads: int) -> int:
        """Worker count capped at the machine's core count: no path here
        gains from more threads than cores, and the GIL-free OpenMP encode
        loses under oversubscription. ``TOKENDAGGER_NO_THREAD_CAP=1``
        lifts the cap (tiktoken honours any count)."""
        if os.environ.get("TOKENDAGGER_NO_THREAD_CAP"):
            return max(1, num_threads)
        return max(1, min(num_threads, os.cpu_count() or num_threads))

    def __repr__(self) -> str:
        return f"<TokenDagger {self.name!r}>"

    # ------------------------------------------------------------------
    # Host encode through the native engine
    # ------------------------------------------------------------------
    # Single texts at least this long are cut at provable piece
    # boundaries and encoded across cores (_encode_split_parallel).
    _SPLIT_MIN_BYTES = 4 << 20

    def _host_encode_ordinary(self, text: str) -> list[int]:
        """Ordinary encode on the host: the native engine if there is one."""
        native = self._get_native()
        if native is not None:
            return self._encode_ordinary_bytes(native, text.encode("utf-8"))
        return self._host.encode_ordinary(text)

    def _encode_split_parallel(self, native, data: bytes) -> list[int] | None:
        """Encode ONE long text across cores by cutting it at provable
        piece boundaries. Two byte-local cut rules, each provable for all
        four scanner profiles:

        A) data[p] is an ASCII letter and data[p-1] is \\r or \\n. Every
           profile's letter alternative excludes \\r\\n from its optional
           one-char prefix, so no piece spans the newline into the
           letter; the piece covering the newline (a \\s run, or a punct
           run with its [\\r\\n/]* suffix) ends before a letter. The letter
           starts a fresh piece, derived as at the start of a text.

        B) data[p] == ' ', data[p-1] is an ASCII letter or digit, and
           data[p+1] is an ASCII letter. The letter/number piece ending at
           p cannot take a space; " Y..." is matched by the space-prefixed
           letter alternative alike at a text's start and inside it (a \\s
           run cannot reach p from the left: data[p-1] is not space).

        Merges never cross piece boundaries, so encoding the chunks apart
        is byte-identical to encoding the whole. None => the caller
        encodes the text in one call."""
        n = len(data)
        # one core stays with the main thread: it materializes finished
        # chunks into lists (GIL-bound) while the workers encode ahead
        nthreads = min(16, (os.cpu_count() or 4) - 1)
        k = nthreads * 4  # more chunks than threads: dynamic schedule
        if nthreads < 2:
            return None
        a = np.frombuffer(data, dtype=np.uint8)
        # ~k cuts are needed: probe a small window after each target
        # instead of full-length boolean temporaries
        window = 1 << 16
        cuts_set = set()
        for i in range(1, k):
            t = i * (n // k)
            stop = min(t + 16 * window, n - 2)  # bounded probe per target
            while t < stop:
                w = a[max(t - 1, 0) : min(t - 1 + window, n)]
                letter = ((w >= 65) & (w <= 90)) | ((w >= 97) & (w <= 122))
                rule_a = ((w[:-2] == 0x0A) | (w[:-2] == 0x0D)) & letter[1:-1]
                rule_b = (
                    (letter[:-2] | ((w[:-2] >= 48) & (w[:-2] <= 57)))
                    & (w[1:-1] == 0x20)
                    & letter[2:]
                )
                hits = np.nonzero(rule_a | rule_b)[0]
                if len(hits):
                    cuts_set.add(t - 1 + int(hits[0]) + 1)
                    break
                t += window - 2
        if not cuts_set:
            return None
        cuts = np.array(sorted(cuts_set), dtype=np.int64)
        offs = np.empty(len(cuts) + 2, dtype=np.int64)
        offs[0] = 0
        offs[1:-1] = cuts
        offs[-1] = n
        lists = native.encode_slices_lists(data, offs, num_threads=nthreads)
        if lists is None:
            return None
        out = lists[0]
        for part in lists[1:]:
            out.extend(part)
        return out

    def _host_encode(self, text: str, allowed: AbstractSet[str]) -> list[int]:
        """Full encode on the host: special scan + native segments."""
        native = self._get_native()
        if native is None:
            return self._host.encode(text, allowed)[0]
        if allowed and len(allowed) == len(self._special_tokens):
            # the full allowed set: the native single-pass scan (exact
            # find_all_specials selection; byte-space matching is exact
            # on valid UTF-8, since lead and continuation bytes differ,
            # and a same-position tie's shorter token is a byte prefix of
            # the longer). A subset keeps the Python scan: a special that
            # is not allowed stays ordinary text and must not shadow an
            # allowed one.
            data = text.encode("utf-8")
            if len(data) < self._SPLIT_MIN_BYTES:
                # one C call: scan + GIL-free parallel segment encode +
                # the interleaved list. Larger texts take the scan, then
                # segments, so that multi-MB segments ride the split.
                lst = native.encode_with_specials(
                    data, num_threads=self._effective_threads(
                        min(8, os.cpu_count() or 4)))
                if lst is not None:
                    return lst
            found = native.find_specials(data)
            if found is not None:
                pos, ids = found
                if not len(pos):
                    return self._encode_ordinary_bytes(native, data)
                sp_len = self._special_id_byte_lens()
                out: list[int] = []
                prev = 0
                for p, sid in zip(pos.tolist(), ids.tolist()):
                    if prev < p:
                        out.extend(self._encode_ordinary_bytes(
                            native, data[prev:p]))
                    out.append(sid)
                    prev = p + sp_len[sid]
                if prev < len(data):
                    out.extend(self._encode_ordinary_bytes(native,
                                                           data[prev:]))
                return out
        out = []
        for seg, special_id in self._host.split_specials(text, allowed):
            if special_id is not None:
                out.append(special_id)
            else:
                out.extend(self._host_encode_ordinary(seg))
        return out

    def _special_id_byte_lens(self) -> dict[int, int]:
        """id -> UTF-8 byte length of the special's text (cached)."""
        if self._sp_id_lens is None:
            self._sp_id_lens = {i: len(t.encode("utf-8"))
                                for t, i in self._special_tokens.items()}
        return self._sp_id_lens

    def _encode_ordinary_bytes(self, native, data: bytes) -> list[int]:
        """Ordinary encode of a UTF-8 byte segment through the native
        engine's fast paths (the byte-level twin of
        _host_encode_ordinary)."""
        if not data:
            return []
        if len(data) >= self._SPLIT_MIN_BYTES:
            lst = self._encode_split_parallel(native, data)
            if lst is not None:
                return lst
        lst = native.encode_list(data)
        if lst is not None:
            return lst
        ids = native.encode(data)
        if ids is not None:
            return ids.tolist()
        return self._host.encode_ordinary(data.decode("utf-8"))

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------
    def encode_ordinary(self, text: str) -> list[int]:
        with span("td.encode_ordinary"):
            try:
                if self._use_device(self._nbytes((text,))):
                    return self._get_device().encode_ordinary_batch(
                        [text])[0]
                return self._host_encode_ordinary(text)
            except Exception as e:  # noqa: BLE001
                raise TokenDaggerError(f"Encoding failed: {e}") from e

    def encode(
        self,
        text: str,
        *,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> list[int]:
        with span("td.encode"):
            allowed, disallowed = self._resolve_special(allowed_special,
                                                        disallowed_special)
            self._check_disallowed((text,), disallowed)
            try:
                if self._use_device(self._nbytes((text,))):
                    return self._get_device().encode_batch([text],
                                                           allowed)[0]
                return self._host_encode(text, allowed)
            except ValueError:
                raise
            except Exception as e:  # noqa: BLE001
                raise TokenDaggerError(f"Encoding failed: {e}") from e

    def encode_with_special_tokens(self, text: str) -> list[int]:
        try:
            return self.encode(text, allowed_special="all")
        except TokenDaggerError:
            raise
        except Exception as e:  # noqa: BLE001 - the reference wraps here
            raise TokenDaggerError(f"Encoding failed: {e}") from e

    def encode_batch(
        self,
        text: Sequence[str],
        *,
        num_threads: int = 8,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> list[list[int]]:
        """Batch encode. The device backend encodes every text's ordinary
        segments through one engine; on the host ``num_threads`` workers
        (capped at the core count, :meth:`_effective_threads`) run the
        native engine's GIL-free encode."""
        with span("td.encode_batch"):
            num_threads = self._effective_threads(num_threads)
            allowed, disallowed = self._resolve_special(allowed_special,
                                                        disallowed_special)
            self._check_disallowed(text, disallowed)
            if self._use_device(self._nbytes(text)):
                return self._get_device().encode_batch(list(text), allowed)
            native = self._get_native()
            if native is not None and not allowed and native._py is not None:
                datas = [t.encode("utf-8") for t in text]
                # fewer huge texts than cores: per-text parallelism cannot
                # fill them, so each goes through the intra-text split
                if len(datas) < (os.cpu_count() or 4) and any(
                        len(d) >= self._SPLIT_MIN_BYTES for d in datas):
                    out: list[list[int]] | None = []
                    for d in datas:
                        lst = (self._encode_split_parallel(native, d)
                               if len(d) >= self._SPLIT_MIN_BYTES else None)
                        if lst is None:
                            lst = native.encode_list(d)
                        if lst is None:
                            out = None
                            break
                        out.append(lst)
                    if out is not None:
                        return out
                # one extension call: the GIL-free OpenMP encode of every text
                # and one pass that builds the lists
                lists = native.encode_batch_lists(datas, num_threads)
                if lists is not None:
                    return lists
                with ThreadPoolExecutor(num_threads) as e:
                    lists = list(e.map(native.encode_list, datas))
                if all(x is not None for x in lists):
                    return lists
            arrays = self._encode_batch_host_np(text, allowed, num_threads)
            if arrays is not None:
                return [a.tolist() for a in arrays]
            encoder = functools.partial(self.encode,
                                        allowed_special=allowed_special,
                                        disallowed_special=disallowed_special)
            with ThreadPoolExecutor(num_threads) as e:
                return list(e.map(encoder, text))

    def _encode_batch_host_np(
        self, text: Sequence[str], allowed: AbstractSet[str], num_threads: int
    ) -> list[np.ndarray] | None:
        """The native engine's batch path: worker threads run only the
        GIL-free C++ encode, giving int32 arrays; the Python-object work
        stays in the caller's thread. None => the caller takes the
        generic path."""
        native = self._get_native()
        if native is None:
            return None
        if allowed:
            # specials: split on the host, encode the segments natively
            plans = []
            segs: list[bytes] = []
            for t in text:
                plan = []
                for seg, special_id in self._host.split_specials(t, allowed):
                    if special_id is not None:
                        plan.append(("sp", special_id))
                    else:
                        plan.append(("seg", len(segs)))
                        segs.append(seg.encode("utf-8"))
                plans.append(plan)
            with ThreadPoolExecutor(num_threads) as e:
                enc = list(e.map(native.encode, segs))
            if any(a is None for a in enc):
                return None
            out = []
            for plan in plans:
                parts = [np.asarray([payload], dtype=np.int32)
                         if kind == "sp" else enc[payload]
                         for kind, payload in plan]
                out.append(np.concatenate(parts) if parts
                           else np.empty(0, np.int32))
            return out
        # threads over per-text GIL-free native calls: the per-text output
        # allocation runs in parallel and no joined blob is paid
        datas = [t.encode("utf-8") for t in text]
        with ThreadPoolExecutor(num_threads) as e:
            arrays = list(e.map(native.encode, datas))
        if any(a is None for a in arrays):
            return None
        return arrays

    def encode_batch_np(
        self,
        text: Sequence[str],
        *,
        num_threads: int = 8,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> list[np.ndarray]:
        """Batch encode returning numpy int arrays: int64 from the device
        and the Python engine, int32 from the native engine."""
        with span("td.encode_batch"):
            num_threads = self._effective_threads(num_threads)
            allowed, disallowed = self._resolve_special(allowed_special,
                                                        disallowed_special)
            self._check_disallowed(text, disallowed)
            if self._use_device(self._nbytes(text)):
                return [np.asarray(ids, dtype=np.int64)
                        for ids in self._get_device().encode_batch(list(text),
                                                                   allowed)]
            arrays = self._encode_batch_host_np(text, allowed, num_threads)
            if arrays is not None:
                return arrays
            return [np.asarray(self._host_encode(t, allowed), dtype=np.int64)
                    for t in text]

    def encode_ordinary_batch(
        self, text: Sequence[str], *, num_threads: int = 8
    ) -> list[list[int]]:
        """tiktoken-compatible batch encode ignoring special tokens."""
        return self.encode_batch(text, num_threads=num_threads,
                                 allowed_special=set(), disallowed_special=())

    def encode_to_numpy(
        self,
        text: str,
        *,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> np.ndarray:
        """tiktoken-compatible: encode straight to a uint32 array."""
        ids = self.encode(text, allowed_special=allowed_special,
                          disallowed_special=disallowed_special)
        return np.asarray(ids, dtype=np.uint32)

    # Unicode White_Space codepoints (Rust char::is_whitespace semantics;
    # Python str.isspace() also accepts U+001C..001F, which would diverge
    # from tiktoken here)
    _WHITE_SPACE = frozenset(
        [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680]
        + list(range(0x2000, 0x200B)) + [0x2028, 0x2029, 0x202F, 0x205F,
                                         0x3000])

    def _get_unstable_aux(self):
        """(sorted vocab byte strings, rank -> bytes), built lazily for
        encode_with_unstable."""
        if self._unstable_aux is None:
            self._unstable_aux = (
                sorted(self._mergeable_ranks),
                {v: k for k, v in self._mergeable_ranks.items()},
            )
        return self._unstable_aux

    def encode_with_unstable(
        self,
        text: str,
        *,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> tuple[list[int], list[list[int]]]:
        """tiktoken-compatible unstable-token analysis: the stable prefix
        of ``encode(text)`` plus every token sequence the unstable tail
        could begin with if more text were appended. Host engine only.

        The unstable region is the last pretoken's tokens, widened across
        trailing all-space tokens (whitespace splits move as text grows);
        completions are (a) every vocab token extending the unstable
        bytes and (b) for each split point, re-encodings of unstable
        prefix + any vocab token extending the suffix, truncated once they
        cover the unstable bytes; plus the whitespace boundary re-split
        case."""
        allowed, disallowed = self._resolve_special(allowed_special,
                                                    disallowed_special)
        self._check_disallowed((text,), disallowed)
        tokens, lptl = self._host.encode(text, allowed)
        stb, dec = self._get_unstable_aux()
        ranks = self._mergeable_ranks

        def all_space(tid: int) -> bool:
            b = dec.get(tid)
            return b is not None and all(c in b" \n\t" for c in b)

        if lptl > 0 and all_space(tokens[len(tokens) - lptl]):
            while (lptl < len(tokens)
                   and all_space(tokens[len(tokens) - lptl - 1])):
                lptl += 1
        if lptl == 0:
            return tokens, []
        unstable = b"".join(dec[t] for t in tokens[len(tokens) - lptl:])
        stable = tokens[: len(tokens) - lptl]
        if not unstable:
            return stable, []
        completions: set[tuple[int, ...]] = set()

        # (a) single vocab tokens that extend (or equal) the unstable bytes
        i = bisect.bisect_left(stb, unstable)
        while i < len(stb) and stb[i].startswith(unstable):
            completions.add((ranks[stb[i]],))
            i += 1

        # (b) a token may straddle any internal position of the unstable
        # bytes: complete the suffix with every vocab token extending it,
        # re-encode, and keep the sequence prefix covering unstable
        for k in range(1, len(unstable)):
            prefix, suffix = unstable[:k], unstable[k:]
            i = bisect.bisect_left(stb, suffix)
            while i < len(stb) and stb[i].startswith(suffix):
                candidate = prefix + stb[i]
                try:
                    enc_ids = self._host.encode_ordinary(
                        candidate.decode("utf-8"))
                except UnicodeDecodeError:
                    enc_ids = byte_pair_merge(candidate, ranks)
                seq: list[int] = []
                covered = 0
                for tid in enc_ids:
                    seq.append(tid)
                    covered += len(dec[tid])
                    if covered >= len(unstable):
                        break
                completions.add(tuple(seq))
                i += 1

        # whitespace boundary instability: if the unstable bytes end in a
        # complete whitespace char with content before it, the split may
        # move there as text grows
        if len(unstable) > 1:
            ch, w = None, 0
            for k in (1, 2, 3, 4):
                if k > len(unstable):
                    break
                try:
                    s = unstable[len(unstable) - k:].decode("utf-8")
                except UnicodeDecodeError:
                    continue
                if len(s) == 1:
                    ch, w = s, k
                    break
            if (ch is not None and len(unstable) - w > 0
                    and ord(ch) in self._WHITE_SPACE):
                re_enc = byte_pair_merge(unstable[: len(unstable) - w], ranks)
                re_enc += byte_pair_merge(unstable[len(unstable) - w:], ranks)
                completions.add(tuple(re_enc))

        return stable, sorted(list(c) for c in completions)

    # ------------------------------------------------------------------
    # Decoding
    # ------------------------------------------------------------------
    # From this many ids on, decode from the rank -> bytes tables (on the
    # device when routing says so, else the native engine's GIL-free
    # fill) instead of the host engine's per-id dict loop.
    _DECODE_VEC_MIN = 24

    def _decode_tables(self):
        """(offsets, lengths, blob, n_vocab) on ``self.device``: the
        engine's tables where they exist, else built from the ranks alone
        (and later handed to the engine)."""
        if self._decode is None:
            t = self._tables
            self._decode = (
                decode_tables_from_ranks(self._mergeable_ranks,
                                         self._special_tokens,
                                         device=self.device)
                if t is None else (t.decode_offsets, t.decode_lengths,
                                   t.decode_blob, t.n_vocab))
            self._decode_lengths = self._decode[1].cpu().numpy()
        return self._decode

    def _host_decode_tables(self):
        """(offsets int64, lengths int32, blob uint8, n_vocab) as numpy
        arrays, for the host decodes."""
        if self._host_decode is None:
            self._host_decode = build_decode_tables(self._mergeable_ranks,
                                                    self._special_tokens)
        return self._host_decode

    @staticmethod
    def _id_lengths(ids: np.ndarray, lengths: np.ndarray,
                    n_vocab: int) -> np.ndarray:
        """Each id's byte length; KeyError on the first id outside the
        vocabulary or without bytes, as the host engine raises."""
        if ids.size and (ids.min() < 0 or ids.max() >= n_vocab):
            bad = ids[(ids < 0) | (ids >= n_vocab)][0]
            raise KeyError(f"Unknown token id: {int(bad)}")
        lens = lengths[ids]
        if (lens < 0).any():
            raise KeyError(f"Unknown token id: {int(ids[lens < 0][0])}")
        return lens

    def _decode_bytes_device(self, ids: np.ndarray) -> bytes:
        """``ops/decode.decode_ids`` against the decode tables; ids are
        validated on the host first. Output caps are powers of two."""
        from .ops.decode import decode_ids

        offsets, lengths, blob, n_vocab = self._decode_tables()
        lens = self._id_lengths(ids, self._decode_lengths, n_vocab)
        total = int(lens.sum(dtype=np.int64))
        if total == 0:
            return b""
        cap = 1 << max(12, (total - 1).bit_length())
        out, _ = decode_ids(torch.from_numpy(ids).to(self.device),
                            offsets, lengths, blob, cap)
        return out[:total].cpu().numpy().tobytes()

    def _decode_bytes_vec(self, ids: np.ndarray) -> bytes:
        """The numpy gather over the host decode tables (no native
        engine); KeyError on an unknown id."""
        offsets, lengths, blob, n_vocab = self._host_decode_tables()
        lens = self._id_lengths(ids, lengths, n_vocab).astype(np.int64)
        offs = offsets[ids]
        total = int(lens.sum())
        pos = np.repeat(offs, lens) + (
            np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(lens) - lens, lens))
        return blob[pos].tobytes()

    def decode_bytes(self, tokens: Sequence[int]) -> bytes:
        try:
            if len(tokens) >= self._DECODE_VEC_MIN:
                # ~4 output bytes per id: the same routing as encode
                if self._use_device(len(tokens) * 4):
                    return self._decode_bytes_device(
                        np.asarray(tokens, dtype=np.int64))
                # the native fill: a list goes straight to the extension
                # (no numpy conversion), an array to the ctypes fill; both
                # raise the numpy path's KeyError on an unknown id
                offsets, lengths, blob, _ = self._host_decode_tables()
                if isinstance(tokens, np.ndarray):
                    ids = np.ascontiguousarray(tokens, dtype=np.int64)
                    out = _native.decode_ids(ids, offsets, lengths, blob)
                    return out if out is not None else (
                        self._decode_bytes_vec(ids))
                out = _native.decode_list(
                    tokens if isinstance(tokens, (list, tuple))
                    else list(tokens), offsets, lengths, blob)
                if out is not None:
                    return out
                return self._decode_bytes_vec(
                    np.asarray(tokens, dtype=np.int64))
            return self._host.decode_bytes(list(tokens))
        except Exception as e:  # noqa: BLE001
            raise TokenDaggerError(f"Decoding failed: {e}") from e

    def decode(self, tokens: Sequence[int], errors: str = "replace") -> str:
        data = self.decode_bytes(tokens)
        try:
            return data.decode("utf-8", errors=errors)
        except (UnicodeDecodeError, LookupError) as e:
            raise TokenDaggerError(f"Decoding failed: {e}") from e

    def _decode_batch_serial(self) -> bool:
        """With the native extension, a batch decodes in a plain loop:
        its fill runs in parallel inside the extension and the rest of
        each item holds the GIL, so a thread pool adds only overhead.
        Without it, a pool (numpy's gathers release the GIL for
        stretches)."""
        return _native.get_pymod() is not None

    def decode_batch(
        self,
        tokens: Sequence[Sequence[int]],
        *,
        num_threads: int = 8,
        errors: str = "replace",
    ) -> list[str]:
        decoder = functools.partial(self.decode, errors=errors)
        if self._decode_batch_serial():
            return [decoder(t) for t in tokens]
        with ThreadPoolExecutor(self._effective_threads(num_threads)) as e:
            return list(e.map(decoder, tokens))

    def decode_bytes_batch(
        self, tokens: Sequence[Sequence[int]], *, num_threads: int = 8
    ) -> list[bytes]:
        """tiktoken-compatible batch of :meth:`decode_bytes`."""
        if self._decode_batch_serial():
            return [self.decode_bytes(t) for t in tokens]
        with ThreadPoolExecutor(self._effective_threads(num_threads)) as e:
            return list(e.map(self.decode_bytes, tokens))

    # ------------------------------------------------------------------
    # Utility
    # ------------------------------------------------------------------
    def special_tokens(self) -> list[str]:
        return list(self._special_tokens.keys())

    def decode_tokens_bytes(self, tokens: Sequence[int]) -> list[bytes]:
        """tiktoken-compatible: per-token byte strings."""
        return [self.decode_single_token_bytes(t) for t in tokens]

    def decode_with_offsets(
        self, tokens: Sequence[int]
    ) -> tuple[str, list[int]]:
        """tiktoken-compatible: decoded text plus the starting character
        offset of each token (UTF-8 continuation-aware, matching
        tiktoken's convention)."""
        token_bytes = self.decode_tokens_bytes(tokens)
        text_len, offsets = 0, []
        for tb in token_bytes:
            offsets.append(max(0, text_len - (0x80 <= tb[0] < 0xC0)))
            text_len += sum(1 for b in tb if not 0x80 <= b < 0xC0)
        text = b"".join(token_bytes).decode("utf-8", errors="strict")
        return text, offsets

    def decode_single_token_bytes(self, token: int) -> bytes:
        """tiktoken-compatible: the bytes of one token id (raises KeyError
        on unknown ids)."""
        try:
            return self._host.decode_bytes([token])
        except KeyError as e:
            raise KeyError(token) from e

    def encode_single_token(self, text_or_bytes: str | bytes) -> int:
        """tiktoken-compatible: the id of an exact token (ordinary or
        special); raises KeyError if the input is not a single token."""
        if isinstance(text_or_bytes, str):
            r = self._special_tokens.get(text_or_bytes)
            if r is not None:
                return r
            text_or_bytes = text_or_bytes.encode("utf-8")
        r = self._mergeable_ranks.get(text_or_bytes)
        if r is None:
            # tiktoken also resolves special-token BYTES: on an encoder
            # miss it decodes the bytes and probes the special encoder
            try:
                r = self._special_tokens.get(text_or_bytes.decode("utf-8"))
            except UnicodeDecodeError:
                r = None
            if r is None:
                raise KeyError(text_or_bytes)
        return r

    def token_byte_values(self) -> list[bytes]:
        """tiktoken-compatible: all ordinary token byte strings, sorted
        lexicographically (tiktoken's ``sorted_token_bytes``), as a copy."""
        if self._sorted_bytes is None:
            self._sorted_bytes = sorted(self._mergeable_ranks)
        return list(self._sorted_bytes)

    @property
    def eot_token(self) -> int:
        """tiktoken-compatible end-of-text id (strictly '<|endoftext|>',
        raising KeyError otherwise, as tiktoken does)."""
        return self._special_tokens["<|endoftext|>"]

    @property
    def special_tokens_set(self) -> set[str]:
        return set(self._special_tokens.keys())

    @property
    def n_vocab(self) -> int:
        return self.max_token_value + 1

    def is_special_token(self, token: int) -> bool:
        return token in self._special_tokens.values()

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _resolve_special(self, allowed, disallowed):
        if allowed == "all":
            # the host engine's canonical frozenset: passing this exact
            # object downstream skips per-call re-validation
            allowed = self._host.all_specials
        else:
            # tiktoken semantics: names that are not special tokens of
            # this encoding are silently inert
            allowed = set(allowed) & self._special_tokens.keys()
        if disallowed == "all":
            if allowed is self._host.all_specials:
                disallowed = frozenset()
            elif allowed:
                disallowed = set(self._special_tokens.keys()) - allowed
            else:
                disallowed = self._all_specials_frozen
        return allowed, disallowed

    def _check_disallowed(self, texts: Sequence[str], disallowed) -> None:
        """Disallowed-special check of each of ``texts`` (a substring
        scan), with an exact bigram prefilter: a token can only occur if
        its leading bigram occurs, so one scan per distinct bigram replaces
        one per token."""
        if not disallowed:
            return
        if disallowed is self._all_specials_frozen:
            groups = self._disallowed_all_groups
            if groups is None:
                fresh: dict[str, list[str]] = {}
                for token in disallowed:
                    fresh.setdefault(token[:2], []).append(token)
                self._disallowed_all_groups = groups = fresh
        else:
            groups = {}
            for token in disallowed:
                groups.setdefault(token[:2], []).append(token)
        with span("td.specials"):
            token = next((token for text in texts
                          for bigram, tokens in groups.items()
                          if bigram in text
                          for token in tokens if token in text), None)
        if token is not None:
            # tiktoken's exact message
            raise ValueError(
                f"Encountered text corresponding to disallowed"
                f" special token {token!r}.\n"
                f"If you want this text to be encoded as a"
                f" special token, pass it to `allowed_special`,"
                f" e.g. `allowed_special={{{token!r}, ...}}`.\n"
                f"If you want this text to be encoded as normal"
                f" text, disable the check for this token by"
                f" passing `disallowed_special=(enc."
                f"special_tokens_set - {{{token!r}}})`.\n"
                f"To disable this check for all special tokens,"
                f" pass `disallowed_special=()`.\n"
            )


# ----------------------------------------------------------------------
# Convenience factories
# ----------------------------------------------------------------------
def load_tokenizer(
    name: str,
    vocab_file: str | Path,
    pattern: str,
    special_tokens_file: str | Path | None = None,
    **kwargs,
) -> Tokenizer:
    """Tokenizer from a JSON vocab file; ``kwargs`` (backend, device,
    tables) go to :class:`Tokenizer`."""
    return Tokenizer(name=name, pattern=pattern, vocab_file=vocab_file,
                     special_tokens_file=special_tokens_file, **kwargs)


def create_tokenizer(
    name: str,
    pattern: str,
    vocab: list[dict],
    special_tokens: dict[str, int] | None = None,
    **kwargs,
) -> Tokenizer:
    """Tokenizer from a list-of-dicts vocab; ``kwargs`` as for
    :func:`load_tokenizer`."""
    return Tokenizer(name=name, pattern=pattern, vocab=vocab,
                     special_tokens=special_tokens, **kwargs)


def Encoding(
    name: str,
    *,
    pat_str: str,
    mergeable_ranks: dict[bytes, int],
    special_tokens: dict[str, int] | None = None,
    explicit_n_vocab: int | None = None,
    **kwargs,
) -> Tokenizer:
    """tiktoken-compatible factory; ``kwargs`` as for
    :func:`load_tokenizer`.

    ``explicit_n_vocab`` mirrors tiktoken's constructor check: when given,
    the vocab (ordinary + special) must have exactly that many entries and
    the max token id must be ``explicit_n_vocab - 1``."""
    tok = Tokenizer(name=name, pat_str=pat_str,
                    mergeable_ranks=mergeable_ranks,
                    special_tokens=special_tokens or {}, **kwargs)
    if explicit_n_vocab:
        if (len(mergeable_ranks) + len(special_tokens or {})
                != explicit_n_vocab
                or tok.max_token_value != explicit_n_vocab - 1):
            raise AssertionError(
                f"explicit_n_vocab {explicit_n_vocab} does not match the "
                "vocabulary")
    return tok
