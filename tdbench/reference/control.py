"""The controls: the reference with one stated guarantee broken.

A configuration states no precision: it states that every id is
tiktoken's for its ``pat_str``, ranks and specials. Each control breaks
one part of that, as a change made for speed might:

* ``misses_as_bytes``: a pretoken that is not itself a token is left
  unmerged, as its bytes' single-byte ranks (a shortcut past the host's
  splice of the device's misses);
* ``specials_as_text``: allowed special tokens are encoded as ordinary
  text (a shortcut past the specials check and split).

Each is put in the program's place and must come out as not correct.
"""

from __future__ import annotations

from .encode import Reference


class MissesAsBytes(Reference):
    def encode_piece(self, piece: bytes) -> list[int]:
        r = self.ranks.get(piece)
        if r is not None:
            return [r]
        return [self.ranks[piece[i:i + 1]] for i in range(len(piece))]


class SpecialsAsText(Reference):
    def encode(self, text: str) -> list[int]:
        return self.encode_ordinary(text)


CONTROLS = {"misses_as_bytes": MissesAsBytes,
            "specials_as_text": SpecialsAsText}


class AsProgram:
    """A reference with the port's call signatures, to run in its place
    (every special allowed, as the traffic asks)."""

    def __init__(self, ref: Reference):
        self.ref = ref

    def encode(self, text: str, **_) -> list[int]:
        return self.ref.encode(text)


def program(name: str):
    """``run.run_cell``'s ``program`` for the control ``name``."""
    cls = CONTROLS[name]
    return lambda pat_str, ranks, specials: AsProgram(
        cls(pat_str, ranks, specials))
