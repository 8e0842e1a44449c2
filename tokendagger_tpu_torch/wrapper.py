"""tiktoken-compatible public API of the port.

``Tokenizer`` (and the ``Encoding``/``create_tokenizer``/``load_tokenizer``
factories) is the port's own copy of the JAX package's ``wrapper.py``
surface. Backends:

* ``"device"`` (the default) encodes through ``engine.DeviceEngine`` on
  ``device`` (default ``"cuda"``; ``"cpu"`` runs every kernel's plain
  version) and decodes large id lists there with ``ops/decode.decode_ids``;
* ``"host"`` uses the exact ``hostengine.HostEngine``;
* ``"auto"`` sends inputs under ``_DEVICE_MIN_BYTES`` to the host engine
  and the rest to the device, by size alone.

``DeviceEngine`` serves every tokenizer: a pattern of the four profiles
with a rank for every single byte takes its stream path, any other its
piece path (a host split, then the device BPE merge). Decoding needs
only the rank -> bytes tables. With ``"device"`` or ``"auto"`` and no card,
construction raises; a device or kernel failure raises too (wrapped as
``TokenDaggerError``) and is never rerouted to the host. Both engines
emit the same ids.
"""

from __future__ import annotations

import bisect
import json
import threading
from pathlib import Path
from typing import AbstractSet, Collection, Literal, Sequence

import numpy as np
import torch

from .convert import (
    EngineTables, decode_tables_from_ranks, engine_tables_from_ranks,
)
from .engine import DeviceEngine
from .hostengine import HostEngine, byte_pair_merge
from .vocab import vocab_list_to_ranks

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
    # Below this many input bytes "auto" keeps the host engine. The JAX
    # package's threshold, taken over unmeasured: the card's crossover is
    # not known yet.
    _DEVICE_MIN_BYTES = 16384

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

    def _use_device(self, nbytes: int) -> bool:
        """Size routing, for encode and decode."""
        if self.backend == "host":
            return False
        if self.backend == "device":
            return True
        return nbytes >= self._DEVICE_MIN_BYTES

    @staticmethod
    def _nbytes(text: str) -> int:
        """UTF-8 byte length (the unit _DEVICE_MIN_BYTES is in)."""
        return len(text) if text.isascii() else len(text.encode("utf-8"))

    def __repr__(self) -> str:
        return f"<TokenDagger {self.name!r}>"

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------
    def encode_ordinary(self, text: str) -> list[int]:
        try:
            if self._use_device(self._nbytes(text)):
                return self._get_device().encode_ordinary_batch([text])[0]
            return self._host.encode_ordinary(text)
        except Exception as e:  # noqa: BLE001
            raise TokenDaggerError(f"Encoding failed: {e}") from e

    def encode(
        self,
        text: str,
        *,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> list[int]:
        allowed, disallowed = self._resolve_special(allowed_special,
                                                    disallowed_special)
        self._check_disallowed(text, disallowed)
        return self._encode_texts([text], allowed)[0]

    def _encode_texts(self, texts: Sequence[str],
                      allowed: AbstractSet[str]) -> list[list[int]]:
        try:
            if self._use_device(sum(self._nbytes(t) for t in texts)):
                return self._get_device().encode_batch(list(texts), allowed)
            return [self._host.encode(t, allowed)[0] for t in texts]
        except Exception as e:  # noqa: BLE001
            raise TokenDaggerError(f"Encoding failed: {e}") from e

    def encode_with_special_tokens(self, text: str) -> list[int]:
        return self.encode(text, allowed_special="all")

    def encode_batch(
        self,
        text: Sequence[str],
        *,
        num_threads: int = 8,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> list[list[int]]:
        """Batch encode. The device backend encodes every text's ordinary
        segments through one engine; ``num_threads`` is accepted for
        tiktoken compatibility (the host engine is pure Python, so threads
        would not run it faster)."""
        allowed, disallowed = self._resolve_special(allowed_special,
                                                    disallowed_special)
        for t in text:
            self._check_disallowed(t, disallowed)
        return self._encode_texts(text, allowed)

    def encode_batch_np(
        self,
        text: Sequence[str],
        *,
        num_threads: int = 8,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> list[np.ndarray]:
        """Batch encode returning int64 numpy arrays."""
        return [np.asarray(ids, dtype=np.int64) for ids in self.encode_batch(
            text, num_threads=num_threads, allowed_special=allowed_special,
            disallowed_special=disallowed_special)]

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
        self._check_disallowed(text, disallowed)
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
    # Under the device backend, from this many ids on decode on the device
    # (``ops/decode.decode_ids``); shorter lists take the host engine.
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

    def _decode_bytes_device(self, ids: np.ndarray) -> bytes:
        """``ops/decode.decode_ids`` against the decode tables; ids are
        validated on the host first (KeyError on an unknown id, as the
        host engine). Output caps are powers of two."""
        from .ops.decode import decode_ids

        offsets, lengths, blob, n_vocab = self._decode_tables()
        if ids.min() < 0 or ids.max() >= n_vocab:
            bad = ids[(ids < 0) | (ids >= n_vocab)][0]
            raise KeyError(f"Unknown token id: {int(bad)}")
        lens = self._decode_lengths[ids]
        if (lens < 0).any():
            raise KeyError(f"Unknown token id: {int(ids[lens < 0][0])}")
        total = int(lens.sum(dtype=np.int64))
        if total == 0:
            return b""
        cap = 1 << max(12, (total - 1).bit_length())
        out, _ = decode_ids(torch.from_numpy(ids).to(self.device),
                            offsets, lengths, blob, cap)
        return out[:total].cpu().numpy().tobytes()

    def decode_bytes(self, tokens: Sequence[int]) -> bytes:
        try:
            # ~4 output bytes per id: the same routing as encode
            if (len(tokens) >= self._DECODE_VEC_MIN
                    and self._use_device(len(tokens) * 4)):
                return self._decode_bytes_device(
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

    def decode_batch(
        self,
        tokens: Sequence[Sequence[int]],
        *,
        num_threads: int = 8,
        errors: str = "replace",
    ) -> list[str]:
        return [self.decode(t, errors=errors) for t in tokens]

    def decode_bytes_batch(
        self, tokens: Sequence[Sequence[int]], *, num_threads: int = 8
    ) -> list[bytes]:
        """tiktoken-compatible batch of :meth:`decode_bytes`."""
        return [self.decode_bytes(t) for t in tokens]

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

    def _check_disallowed(self, text: str, disallowed) -> None:
        """Disallowed-special check (a substring scan), with an exact
        bigram prefilter: a token can only occur if its leading bigram
        occurs, so one scan per distinct bigram replaces one per token."""
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
        for bigram, tokens in groups.items():
            if bigram in text:
                for token in tokens:
                    if token in text:
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
