"""Incremental (streaming) encoding and the safe-cut analysis in
character units.

A pretoken piece can only be changed by text appended later while it
touches the character-class run at the end of the buffer (plus a bounded
lookahead), and a special token can only appear later if the buffer ends
with a prefix of one. ``_safe_cut_chars`` finds where that run starts;
the device engine's ``_host_advance`` encodes only the pieces that end
before it, and ``StreamingEncoder`` emits only those.
``engine.DeviceEngine._safe_cut_threshold`` is the same analysis in byte
units (``CUT_SLACK`` = 16 bytes = 4 chars x 4 bytes); a change to either
must land in both.

Invariant (tested): for any chunking of ``text``,
    sum(feed(chunk) for chunk) + flush() == Tokenizer.encode(text).
"""

from __future__ import annotations

from typing import AbstractSet, Literal

import numpy as np

from .unicode_tables import LC, LETTER, NUM, UC, WS, get_tables

# lookahead slack in chars (contraction <= 3 chars + the (?!\S) peek)
_SLACK_CHARS = 4


def coarse_classes(cps: np.ndarray) -> np.ndarray:
    """Coarse class of each codepoint for run finding: 0 whitespace, 1
    number (not a letter), 2 letter, 3 anything else."""
    classes, _ = get_tables()
    cls = classes[cps.astype(np.int64)]
    ws = (cls & WS) != 0
    wd = (cls & (UC | LC | LETTER)) != 0
    num = ((cls & NUM) != 0) & ~wd
    return np.where(ws, 0, np.where(num, 1, np.where(wd, 2, 3)))


def _safe_cut_chars(text: str) -> int:
    """Largest char index rs such that pretoken pieces ending <= rs cannot
    be changed by appending more text: start of the coarse class run
    touching the end, minus lookahead slack.

    If the examined tail is one unbroken class run the run may begin even
    earlier, so the backward search extends until a class change is found
    (or the whole buffer turns out to be one run -> hold everything back)."""
    if not text:
        return 0
    tail_n = 8192
    while True:
        tail = text[-tail_n:]
        base = len(text) - len(tail)
        co = coarse_classes(
            np.frombuffer(tail.encode("utf-32-le"), dtype=np.uint32))
        diff = np.nonzero(co != co[-1])[0]
        if len(diff) == 0:
            if base == 0:
                return 0  # whole buffer is one run: nothing is final yet
            tail_n *= 4  # run may start before the tail: look further back
            continue
        run_start = base + int(diff[-1]) + 1
        return max(0, run_start - _SLACK_CHARS)


class StreamingEncoder:
    """Incremental encoder over a ``Tokenizer``.

    ``feed(chunk)`` returns the token ids that are final given the input
    so far; ``flush()`` returns the ids of the held-back tail and resets.
    Memory held between calls is bounded by the longest class run plus the
    longest allowed special token. Both encode through the tokenizer's
    own backend: ``feed`` the final part of each ordinary segment
    (``Tokenizer.encode_ordinary``), ``flush`` the tail
    (``Tokenizer.encode``).
    """

    def __init__(
        self,
        tokenizer,
        *,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),
    ):
        from .vocab import classify_pattern

        # The safe-cut analysis holds only for the supported pattern
        # profiles (matches bounded by class runs + <=4 chars lookahead).
        # An arbitrary pattern could match across runs, so streaming it
        # would diverge from Tokenizer.encode: refuse instead.
        if classify_pattern(tokenizer.pattern) is None:
            raise ValueError(
                "StreamingEncoder requires a supported pattern profile "
                "(Llama-4/o200k, Tekken, cl100k or gpt2); use "
                "Tokenizer.encode for arbitrary patterns")
        self._tok = tokenizer
        if allowed_special == "all":
            allowed_special = set(tokenizer.special_tokens_set)
        self._allowed = set(allowed_special)
        for t in self._allowed:
            if t not in tokenizer.special_tokens_set:
                raise KeyError(f"Unknown special token: {t!r}")
        self._buf = ""
        # every proper prefix of every allowed special: the holdback is
        # O(max_len) set lookups per feed
        self._prefixes: set[str] = set()
        for sp in self._allowed:
            for k in range(1, len(sp)):
                self._prefixes.add(sp[:k])
        self._max_prefix = max((len(p) for p in self._prefixes), default=0)

    def _special_holdback(self, text: str) -> int:
        """Length of the longest proper suffix of ``text`` that is a prefix
        of an allowed special token (more input may complete it)."""
        for k in range(min(self._max_prefix, len(text)), 0, -1):
            if text[-k:] in self._prefixes:
                return k
        return 0

    def feed(self, chunk: str) -> list[int]:
        self._buf += chunk
        text = self._buf
        if not text:
            return []
        safe_end = len(text) - self._special_holdback(text)
        region = text[:safe_end]
        rs = _safe_cut_chars(region)
        if rs <= 0:
            return []

        host = self._tok._host
        allowed_sorted = [t for t in host._specials_by_len
                          if t in self._allowed]
        out: list[int] = []
        consumed = 0
        start = 0
        cache: dict[str, int] = {}
        while start < len(region):
            pos_sp, tok_sp = host._find_next_special(
                region, start, allowed_sorted, cache)
            seg_end = pos_sp if pos_sp != -1 else len(region)
            # the last piece of this ordinary segment ending at or before
            # rs, and not in whitespace: the final pieces are encoded as one
            # text, where "\s+(?!\S)" would take a whitespace piece that
            # the text goes on to cut short ("a \u3000\u3000'x": the run
            # splits before its last char, but not at the end of a text)
            last_end = start
            for a, e in host.split_spans(region[start:seg_end]):
                end = start + e
                if end > rs:
                    break
                if not region[end - 1].isspace():
                    last_end = end
            if last_end > start:
                out.extend(self._tok.encode_ordinary(
                    region[start:last_end]))
                consumed = last_end
            if last_end < seg_end or tok_sp is None:
                break  # stopped mid-segment (or no further special)
            sp_end = seg_end + len(tok_sp)
            if sp_end > rs:
                break
            out.append(host.special_tokens[tok_sp])
            consumed = sp_end
            start = sp_end
        self._buf = text[consumed:]
        return out

    def flush(self) -> list[int]:
        """Encode the held-back tail (end-of-input semantics) and reset."""
        out = self._tok.encode(self._buf, allowed_special=self._allowed,
                               disallowed_special=())
        self._buf = ""
        return out
