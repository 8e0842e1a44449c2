"""Exact sequential BPE engine (host CPU reference path).

This is the framework's *oracle* implementation: byte-for-byte identical
token ids to tiktoken / the reference C++ engine. It is used

* as the correctness reference for the device path, and
* by the window pipeline for the windows it cannot take (non-ASCII,
  capacity overflow) and for splicing pieces its probe missed.

Semantics mirrored from the reference C++ engine (behavioral spec only):
* regex pretokenization: src/tiktoken/tiktoken.cpp:70-128
* BPE merge loop (leftmost-min-rank, look-3-parts-ahead rank refresh):
  src/tiktoken/tiktoken.cpp:282-378
* whole-piece direct-lookup fast path: src/tiktoken/tiktoken.cpp:210-215

This is the ordinary-text part of the JAX package's engine; the
special-token and decode methods come with the public API.
"""

from __future__ import annotations

MAX_RANK = 0x7FFFFFFF


def byte_pair_merge(piece: bytes, ranks: dict[bytes, int]) -> list[int]:
    """Exact sequential BPE merge of one pretoken.

    Maintains ``parts`` as a list of ``[start, rank_of_pair_starting_here]``
    and repeatedly merges the leftmost minimum-rank adjacent pair, matching
    the reference loop at src/tiktoken/tiktoken.cpp:298-367.
    """
    n = len(piece)
    # parts[i] = [byte_start, rank of piece[parts[i][0]:parts[i+2][0]]]
    parts: list[list[int]] = []
    min_rank = MAX_RANK
    min_idx = -1
    for i in range(n - 1):
        r = ranks.get(piece[i : i + 2], MAX_RANK)
        if r < min_rank:
            min_rank = r
            min_idx = i
        parts.append([i, r])
    parts.append([n - 1, MAX_RANK])
    parts.append([n, MAX_RANK])

    def get_rank(i: int) -> int:
        if i + 3 < len(parts):
            return ranks.get(piece[parts[i][0] : parts[i + 3][0]], MAX_RANK)
        return MAX_RANK

    while min_rank != MAX_RANK:
        i = min_idx
        if i > 0:
            parts[i - 1][1] = get_rank(i - 1)
        parts[i][1] = get_rank(i)
        del parts[i + 1]

        min_rank = MAX_RANK
        min_idx = -1
        for j in range(len(parts) - 1):
            r = parts[j][1]
            if r < min_rank:
                min_rank = r
                min_idx = j

    out = []
    for j in range(len(parts) - 1):
        out.append(ranks[piece[parts[j][0] : parts[j + 1][0]]])
    return out


def byte_pair_encode(piece: bytes, ranks: dict[bytes, int]) -> list[int]:
    """Encode one pretoken: 1-byte fast path then merge loop
    (reference: src/tiktoken/tiktoken.cpp:370-378)."""
    if len(piece) == 1:
        return [ranks[piece]]
    return byte_pair_merge(piece, ranks)


class HostEngine:
    """Sequential, exact CoreBPE-equivalent engine over Python data."""

    def __init__(
        self,
        pattern: str,
        mergeable_ranks: dict[bytes, int],
        special_tokens: dict[str, int],
    ):
        self.pattern = pattern
        self.ranks = dict(mergeable_ranks)
        self.special_tokens = dict(special_tokens)
        # Supported profiles split via the class-run scanner over the
        # tiktoken-calibrated class table (see split_spans); the regex
        # engine serves generic patterns only, so the `regex` module is
        # needed only for those.
        from .vocab import classify_pattern

        self._scan_profile = classify_pattern(pattern)
        self._re = None
        if self._scan_profile is None:
            # \p{..} Unicode categories and (?i:..) scoped
            # case-insensitivity like PCRE2
            import regex

            self._re = regex.compile(pattern)

    # ------------------------------------------------------------------
    # Pretokenization
    # ------------------------------------------------------------------
    def split_spans(self, text: str) -> list[tuple[int, int]]:
        """Pretoken spans as (start, end) character offsets.

        Supported pattern profiles split via the class-run scanner over
        the CALIBRATED class table (unicode_tables.py): the `regex`
        module's Unicode version differs from the tiktoken oracle's on
        ~10k codepoints, so the regex engine itself is only the split
        oracle for UNSUPPORTED patterns (where the divergence on those
        codepoints is documented, not fixable)."""
        if self._scan_profile is not None:
            from .scanner_ref import split_spans as _scan_spans

            return _scan_spans(text, profile=self._scan_profile)
        return [m.span() for m in self._re.finditer(text)]

    def split(self, text: str) -> list[str]:
        return [text[a:b] for a, b in self.split_spans(text)]

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------
    def encode_ordinary(self, text: str) -> list[int]:
        """Encode ignoring special tokens.

        Includes the whole-piece direct-lookup fast path, matching the
        tiktoken oracle (the reference C++ omits it here with a TODO,
        tiktoken.cpp:162 — identical results for merge-closed vocabs, but
        tiktoken's behavior is the conformance target for the rest)."""
        out: list[int] = []
        for a, b in self.split_spans(text):
            piece = text[a:b].encode("utf-8")
            r = self.ranks.get(piece)
            if r is not None:
                out.append(r)
            else:
                out.extend(byte_pair_encode(piece, self.ranks))
        return out
