"""Plain reference encoder: what tiktoken's ``Encoding.encode`` returns.

Specials first: the text is cut at each occurrence of an allowed special
token (leftmost first); each special gives its id, and each ordinary
segment is split by the published pattern (``pretok``) and every pretoken
is encoded by byte-pair merging over the mergeable ranks: a pretoken that
is itself a token gives its rank, and any other starts as single bytes
and repeatedly merges the adjacent pair whose concatenation has the lowest
rank (the leftmost such pair on a tie) until no adjacent pair is a token.

It is independent of the program under test and takes nothing the program
made: the ranks and specials are the benchmark's, given to both sides.
"""

from __future__ import annotations

import re

from . import pretok


def byte_pair_merge(piece: bytes, ranks: dict[bytes, int]) -> list[int]:
    """Ranks of the tokens that byte-pair merging splits ``piece`` into."""
    parts = [piece[i:i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best, at = None, -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best is None or r < best):
                best, at = r, i
        if best is None:
            break
        parts[at:at + 2] = [parts[at] + parts[at + 1]]
    return [ranks[p] for p in parts]


class Reference:
    """The reference for one vocabulary: ``encode(text)`` with every
    special of ``specials`` allowed (``allowed_special="all"``)."""

    def __init__(self, pat_str: str, ranks: dict[bytes, int],
                 specials: dict[str, int]):
        self.pat_str = pat_str
        self.ranks = ranks
        self.specials = specials
        # longest first, so that of two specials at one offset the longer
        # wins (no published vocabulary has one special prefixing another)
        self._special_re = re.compile("|".join(
            re.escape(s) for s in sorted(specials, key=len, reverse=True)))
        self._pieces: dict[bytes, list[int]] = {}

    def encode_piece(self, piece: bytes) -> list[int]:
        r = self.ranks.get(piece)
        if r is not None:
            return [r]
        ids = self._pieces.get(piece)
        if ids is None:
            ids = self._pieces[piece] = byte_pair_merge(piece, self.ranks)
        return ids

    def encode_ordinary(self, text: str) -> list[int]:
        out: list[int] = []
        for p in pretok.split(self.pat_str, text):
            out.extend(self.encode_piece(p.encode("utf-8")))
        return out

    def encode(self, text: str) -> list[int]:
        if not self.specials:
            return self.encode_ordinary(text)
        out: list[int] = []
        prev = 0
        for m in self._special_re.finditer(text):
            out.extend(self.encode_ordinary(text[prev:m.start()]))
            out.append(self.specials[m.group(0)])
            prev = m.end()
        out.extend(self.encode_ordinary(text[prev:]))
        return out
