"""Char-aligned window staging: the UTF-8 window trim rule.

A window staged from an arbitrary byte offset of a valid UTF-8 corpus
must itself be valid UTF-8 (each window is encoded as an independent
text by both the kernels and the host oracle), so: skip leading
continuation bytes, and trim a trailing INCOMPLETE multi-byte sequence
(a complete trailing char is kept)."""

from __future__ import annotations

import numpy as np


def char_align(arr: np.ndarray) -> np.ndarray:
    """Trim a uint8 window to a valid-UTF-8 slice (see module doc)."""
    k = 0
    n = len(arr)
    while k < n and (arr[k] & 0xC0) == 0x80:
        k += 1
    arr = arr[k:]
    e = len(arr)
    if e and (arr[e - 1] & 0x80):
        j = e - 1
        while j > max(0, e - 4) and (arr[j] & 0xC0) == 0x80:
            j -= 1
        if (arr[j] & 0xC0) == 0xC0:
            need = 2 if arr[j] < 0xE0 else (3 if arr[j] < 0xF0 else 4)
            if e - j < need:
                e = j
    return arr[:e]


def tile_windows(corpus: bytes, window: int, n_windows: int):
    """n_windows char-aligned fixed-shape windows tiled (with wraparound
    strides) over the corpus. Returns (wins (n, window) uint8, nbs (n,)
    int32)."""
    wins = np.zeros((n_windows, window), np.uint8)
    nbs = np.zeros((n_windows,), np.int32)
    for b in range(n_windows):
        lo = (b * window) % max(1, len(corpus) - window)
        arr = char_align(np.frombuffer(corpus[lo : lo + window], np.uint8))
        wins[b, : len(arr)] = arr
        nbs[b] = len(arr)
    return wins, nbs


def stream_windows(corpus: bytes, window: int) -> list[np.ndarray]:
    """Sequential char-aligned cover of the corpus: each window advances
    by its trimmed length, so no byte is lost or duplicated."""
    out: list[np.ndarray] = []
    base = 0
    n = len(corpus)
    while base < n:
        arr = char_align(np.frombuffer(corpus[base : base + window],
                                       np.uint8))
        out.append(arr)
        base += max(len(arr), 1)
    return out
