"""Exact sequential BPE engine (host CPU reference path).

This is the framework's *oracle* implementation: byte-for-byte identical
token ids to tiktoken / the reference C++ engine. It is used

* as the correctness reference for the device path,
* by the public API's host backend, and
* by the window pipelines for the windows they cannot take (capacity
  overflow, and non-ASCII windows in ``ResidentStream``) and for splicing
  pieces their probe missed.

Semantics mirrored from the reference C++ engine (behavioral spec only):
* regex pretokenization: src/tiktoken/tiktoken.cpp:70-128
* BPE merge loop (leftmost-min-rank, look-3-parts-ahead rank refresh):
  src/tiktoken/tiktoken.cpp:282-378
* whole-piece direct-lookup fast path: src/tiktoken/tiktoken.cpp:210-215
* special-token scan with per-token position cache:
  src/tiktoken/tiktoken.cpp:130-154,169-234
"""

from __future__ import annotations

from typing import AbstractSet, Iterable, Sequence

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
        self.decoder: dict[int, bytes] = {r: b for b, r in self.ranks.items()}
        self.special_decoder: dict[int, bytes] = {
            r: s.encode("utf-8") for s, r in self.special_tokens.items()
        }
        # Specials sorted longest-first so that, when two allowed specials
        # match at the same position, the longest wins deterministically.
        self._specials_by_len = sorted(
            self.special_tokens, key=len, reverse=True
        )
        # Single-pass scan support: distinct leading bigrams and distinct
        # lengths of the special vocabulary.
        self._special_prefixes = {t[:2] for t in self.special_tokens}
        self._special_lengths = sorted(
            {len(t) for t in self.special_tokens}, reverse=True
        )
        # canonical allow-all set: callers passing this exact object skip
        # the per-call O(|specials|) membership validation
        self.all_specials: frozenset[str] = frozenset(self.special_tokens)
        # Supported profiles split via the class-run scanner over the
        # tiktoken-calibrated class table (see split_spans); the regex
        # engine serves generic patterns only, so the `regex` module is
        # needed only for those.
        from .vocab import classify_pattern

        self._scan_profile = classify_pattern(pattern)
        self._re = None
        if self._scan_profile is None:
            # \p{..} Unicode categories and (?i:..) scoped
            # case-insensitivity like PCRE2; V1, so that class set
            # operations such as [A&&[^B]] are read as tiktoken reads them
            # (V0 takes "&&" for literal characters)
            import regex

            self._re = regex.compile(pattern, regex.V1)

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

    # ------------------------------------------------------------------
    # Special tokens
    # ------------------------------------------------------------------
    def _find_next_special(
        self, text: str, start: int, allowed: Iterable[str], cache: dict[str, int]
    ) -> tuple[int, str | None]:
        """Earliest occurrence of any allowed special at/after ``start``.

        Positions are cached per token so each special is searched at most
        once per region, mirroring tiktoken.cpp:130-154. Ties at the same
        position resolve to the longest token.
        """
        ABSENT = -2  # token known absent for the rest of the text
        best_pos = -1
        best_tok: str | None = None
        for tok in allowed:
            pos = cache.get(tok)
            if pos == ABSENT:
                continue
            if pos is None or pos < start:
                pos = text.find(tok, start)
                cache[tok] = pos if pos != -1 else ABSENT
                if pos == -1:
                    continue
            if (
                best_pos == -1
                or pos < best_pos
                or (pos == best_pos and len(tok) > len(best_tok or ""))
            ):
                best_pos = pos
                best_tok = tok
        return best_pos, best_tok

    def encode(
        self, text: str, allowed_special: AbstractSet[str]
    ) -> tuple[list[int], int]:
        """Encode with special-token handling.

        Returns ``(tokens, last_piece_token_len)`` like the reference
        (tiktoken.cpp:169-234). Raises ``KeyError`` if ``allowed_special``
        contains an unknown token (reference throws TiktokenError,
        tiktoken.cpp:177-182)."""
        for tok in allowed_special:
            if tok not in self.special_tokens:
                raise KeyError(f"Unknown special token: {tok!r}")

        # Longest-first ordering for deterministic same-position ties.
        allowed = [t for t in self._specials_by_len if t in allowed_special]

        out: list[int] = []
        last_piece_token_len = 0
        cache: dict[str, int] = {}
        start = 0
        n = len(text)
        while start <= n:
            pos, tok = self._find_next_special(text, start, allowed, cache)
            end = pos if pos != -1 else n
            if start < end:
                segment = text[start:end]
                last_piece_token_len = 0
                for a, b in self.split_spans(segment):
                    piece = segment[a:b].encode("utf-8")
                    # whole-piece direct lookup fast path (tiktoken.cpp:210-215)
                    r = self.ranks.get(piece)
                    if r is not None:
                        out.append(r)
                        last_piece_token_len = 1
                    else:
                        ids = byte_pair_encode(piece, self.ranks)
                        out.extend(ids)
                        last_piece_token_len = len(ids)
            if tok is None:
                break
            out.append(self.special_tokens[tok])
            last_piece_token_len = 0
            start = end + len(tok)
            if start > n:
                break
        return out, last_piece_token_len

    def encode_with_special_tokens(self, text: str) -> list[int]:
        tokens, _ = self.encode(text, set(self.special_tokens))
        return tokens

    def find_all_specials(
        self, text: str, allowed: AbstractSet[str]
    ) -> list[tuple[int, str]]:
        """All non-overlapping allowed-special occurrences in document
        order (leftmost match wins; same-position ties go to the longest
        token) — the reference's cached per-token find loop semantics
        (tiktoken.cpp:130-154), computed in a single pass. Tie-break
        caveat: a same-position tie requires one allowed special to be a
        strict prefix of another — absent from every real vocabulary.
        There, this scan picks
        the LONGEST deterministically, while tiktoken's own pick is the
        first alternative of a regex built from HashMap iteration order
        (implementation-defined), and the reference's is emhash set
        order; for prefix-tie-free special sets all three agree exactly.
        Mechanics:
        one ``str.find`` sweep per *distinct leading bigram* of the
        allowed set (typically just "<|") yields candidate positions, and
        each candidate is resolved with one hash lookup per distinct
        special length. O(text + candidates) instead of
        O(|allowed| * text)."""
        positions: list[int] = []
        prefixes = (
            self._special_prefixes
            if len(allowed) == len(self.special_tokens)
            else {t[:2] for t in allowed}
        )
        for pre in prefixes:
            p = text.find(pre)
            while p != -1:
                positions.append(p)
                p = text.find(pre, p + 1)
        if not positions:
            return []
        positions.sort()
        lengths = (
            self._special_lengths
            if len(allowed) == len(self.special_tokens)
            else sorted({len(t) for t in allowed}, reverse=True)
        )
        if not isinstance(allowed, (set, frozenset)):
            allowed = set(allowed)
        out: list[tuple[int, str]] = []
        last_end = 0
        prev = -1
        for p in positions:
            if p < last_end or p == prev:
                continue
            prev = p
            for L in lengths:
                cand = text[p : p + L]
                if len(cand) == L and cand in allowed:
                    out.append((p, cand))
                    last_end = p + L
                    break
        return out

    def split_specials(self, text: str, allowed: AbstractSet[str]):
        """Yield (segment_text, None) / ("", special_id) in document order,
        matching the cached-position scan semantics of the reference
        (tiktoken.cpp:130-154) via the single-pass scanner above. Raises
        KeyError on unknown allowed token."""
        if allowed is not self.all_specials:
            for tok in allowed:
                if tok not in self.special_tokens:
                    raise KeyError(f"Unknown special token: {tok!r}")
        start = 0
        for pos, tok in self.find_all_specials(text, allowed):
            if start < pos:
                yield text[start:pos], None
            yield "", self.special_tokens[tok]
            start = pos + len(tok)
        if start < len(text):
            yield text[start:], None

    # ------------------------------------------------------------------
    # Decoding
    # ------------------------------------------------------------------
    def decode_bytes(self, tokens: Sequence[int]) -> bytes:
        """Concatenate per-id byte strings; raise on unknown ids
        (reference: tiktoken.cpp:236-255)."""
        chunks: list[bytes] = []
        for t in tokens:
            b = self.decoder.get(t)
            if b is None:
                b = self.special_decoder.get(t)
            if b is None:
                raise KeyError(f"Unknown token id: {t}")
            chunks.append(b)
        return b"".join(chunks)
