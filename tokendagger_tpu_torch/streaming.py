"""Safe-cut analysis in character units.

A pretoken piece can only be changed by text appended later while it
touches the character-class run at the end of the buffer (plus a bounded
lookahead). ``_safe_cut_chars`` finds where that run starts; the device
engine's ``_host_advance`` encodes only the pieces that end before it.
``engine.DeviceEngine._safe_cut_threshold`` is the same analysis in byte
units (``CUT_SLACK`` = 16 bytes = 4 chars x 4 bytes); a change to either
must land in both.
"""

from __future__ import annotations

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
