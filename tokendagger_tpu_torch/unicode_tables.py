"""Unicode classification tables for the pretokenizer.

Per-codepoint class bitmask plus the case-fold sets of the contraction
letters, read from the shipped ``data/unicode_classes.npz``. The file is
the JAX package's calibrated table (its ``unicode_tables.get_tables()``,
i.e. the `regex` module's classes with the tiktoken-calibrated overlay
applied) frozen once, so this package needs neither the `regex` module
nor the calibration data at run time; ``tests/test_torch_host.py`` holds
it equal to that table byte for byte.

Bit layout (uint8):
  WS      0x01  \\s          (Unicode whitespace)
  RN      0x02  [\\r\\n]
  LETTER  0x04  \\p{L}
  NUM     0x08  \\p{N}
  UC      0x10  [\\p{Lu}\\p{Lt}\\p{Lm}\\p{Lo}\\p{M}]  ("uppercase-ish" word class)
  LC      0x20  [\\p{Ll}\\p{Lm}\\p{Lo}\\p{M}]          ("lowercase-ish" word class)

``get_two_level_tables()`` compresses it into 256-codepoint pages, the
form the char-per-element functions of ``ops/pretokenize`` take.
``char_class_words(profile)`` widens that table into the 13-bit class word
per codepoint that the piece-start kernel (K1) reads for general text.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

WS = 0x01
RN = 0x02
LETTER = 0x04
NUM = 0x08
UC = 0x10
LC = 0x20

N_CP = 0x110000

# letters whose (?i:x) fold sets the contraction rules need
_CONTRACTION_LETTERS = "stredvml"


def _data_path() -> Path:
    return Path(__file__).with_name("data") / "unicode_classes.npz"


@lru_cache(maxsize=1)
def get_tables() -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """(classes (0x110000,) uint8, {letter: sorted codepoint array})."""
    with np.load(_data_path()) as z:
        classes = z["classes"]
        folds = {L: z[f"fold_{L}"] for L in _CONTRACTION_LETTERS}
    classes.setflags(write=False)
    return classes, folds


@lru_cache(maxsize=1)
def get_two_level_tables() -> tuple[np.ndarray, np.ndarray]:
    """Page-compressed class table: (page_ids (0x1100,) uint8 or uint16,
    pages (n_pages, 256) uint8) with ``classes[cp] ==
    pages[page_ids[cp >> 8], cp & 0xFF]``, the distinct pages in sorted
    order. The char-form functions of ``ops/pretokenize`` take the pair,
    as the JAX package's do."""
    classes, _ = get_tables()
    pages, inverse = np.unique(classes.reshape(-1, 256), axis=0,
                               return_inverse=True)
    dtype = np.uint8 if len(pages) < 256 else np.uint16
    page_ids = inverse.reshape(-1).astype(dtype)
    page_ids.setflags(write=False)
    pages = pages.astype(np.uint8)
    pages.setflags(write=False)
    return page_ids, pages


# Bit order of the class word K1 reads (csrc/starts_derive.cuh, B_WS ..
# B_GL): the six table classes (``let`` is the LETTER bit), the space,
# the apostrophe, [\r\n/], and the four contraction-letter groups.
CLASS_WORD_BITS = ("ws", "rn", "let", "num", "uc", "lc", "sp", "apo", "rnsl",
                   "g1", "grv", "ge", "gl")
# contraction letters of each group: 's 't 'm 'd | 're 've | e | 'll
_FOLD_GROUPS = (("g1", "stmd"), ("grv", "rv"), ("ge", "e"), ("gl", "l"))
_PROFILES = ("llama4", "nocontract", "cl100k", "gpt2")


@lru_cache(maxsize=4)
def char_class_words(profile: str) -> np.ndarray:
    """(0x110000,) uint16: bit i of entry cp is class ``CLASS_WORD_BITS[i]``
    of codepoint cp under ``profile``.

    The contraction groups hold each letter's full case-fold set for
    llama4 and cl100k (the ``(?i:...)`` suffixes), the case-sensitive
    ASCII letters for gpt2, and nothing for nocontract. The first 128
    entries equal ``ops.bitplane.class_lut(profile)``. The table (2.2 MB)
    replaces the JAX package's two-level page table and its row-gather
    lookup."""
    if profile not in _PROFILES:
        raise NotImplementedError(profile)
    classes, folds = get_tables()
    c = classes.astype(np.uint16)
    bit = {name: np.uint16(1 << i) for i, name in enumerate(CLASS_WORD_BITS)}
    words = np.zeros(N_CP, np.uint16)
    for name, cls in (("ws", WS), ("rn", RN), ("let", LETTER), ("num", NUM),
                      ("uc", UC), ("lc", LC)):
        words |= np.where(c & cls, bit[name], np.uint16(0))
    words[ord(" ")] |= bit["sp"]
    words[ord("'")] |= bit["apo"]
    words |= np.where(c & RN, bit["rnsl"], np.uint16(0))
    words[ord("/")] |= bit["rnsl"]
    if profile != "nocontract":
        for name, letters in _FOLD_GROUPS:
            for L in letters:
                cps = [ord(L)] if profile == "gpt2" else folds[L]
                words[np.asarray(cps, np.int64)] |= bit[name]
    words.setflags(write=False)
    return words
