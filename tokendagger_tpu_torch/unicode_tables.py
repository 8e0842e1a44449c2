"""Unicode classification tables for the pretokenizer.

Per-codepoint class bitmask plus the case-fold sets of the contraction
letters, read from the shipped ``data/unicode_classes.npz``. The file is
the JAX package's calibrated table (its ``unicode_tables.get_tables()``,
i.e. the `regex` module's classes with the tiktoken-calibrated overlay
applied) frozen once, so this package needs neither the `regex` module
nor the calibration data at run time; ``tests/test_torch_host.py`` holds
it equal to that table byte for byte.

The Han script (``\\p{Han}``, the Script property, not Script_Extensions),
which Kimi K2's pattern names, is a separate frozen file,
``data/han_script.npz`` (``han_plane()``): the 99,030 code points that
tiktoken (0.13.0) matches by ``\\p{Han}``, found by encoding every code
point but the surrogates under the pattern ``\\p{Han}``. Among the code
points Unicode 15.0 assigns it equals the benchmark's
``tdbench/reference/scripts.HAN`` (98,408); above 15.0 it also holds
Extension I, U+2EBF0-U+2EE5D (622 code points, assigned in 15.1 and
letters in ``classes`` as tiktoken reads them). Its classes: Lo and Lm
(letters), So (the radicals), Po (U+16FE2), Mc (U+16FF0-U+16FF1) and Nl
(U+3007, U+3021-U+3029, U+3038-U+303A).

Bit layout (uint8):
  WS      0x01  \\s          (Unicode whitespace)
  RN      0x02  [\\r\\n]
  LETTER  0x04  \\p{L}
  NUM     0x08  \\p{N}
  UC      0x10  [\\p{Lu}\\p{Lt}\\p{Lm}\\p{Lo}\\p{M}]  ("uppercase-ish" word class)
  LC      0x20  [\\p{Ll}\\p{Lm}\\p{Lo}\\p{M}]          ("lowercase-ish" word class)

``get_two_level_tables()`` compresses it into 256-codepoint pages, the
form the char-per-element functions of ``ops/pretokenize`` take.
``char_class_words(profile)`` widens that table into the class word per
codepoint that the piece-start kernel (K1) reads for general text (13
bits; 14 under ``kimi``, whose last bit is Han). ``kimi_classes()`` is
the uint8 table the ``kimi`` profile's host scanners read: ``classes``
with UC and LC cleared on Han and the bit HAN (0x40) set there.
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
HAN = 0x40  # kimi_classes() only


N_CP = 0x110000

# letters whose (?i:x) fold sets the contraction rules need
_CONTRACTION_LETTERS = "stredvml"


def _data_path(name: str = "unicode_classes.npz") -> Path:
    return Path(__file__).with_name("data") / name


@lru_cache(maxsize=1)
def get_tables() -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """(classes (0x110000,) uint8, {letter: sorted codepoint array})."""
    with np.load(_data_path()) as z:
        classes = z["classes"]
        folds = {L: z[f"fold_{L}"] for L in _CONTRACTION_LETTERS}
    classes.setflags(write=False)
    return classes, folds


@lru_cache(maxsize=1)
def han_plane() -> np.ndarray:
    """(0x110000,) bool: the Han script as tiktoken reads ``\\p{Han}``."""
    with np.load(_data_path("han_script.npz")) as z:
        ranges = z["ranges"]
    plane = np.zeros(N_CP, bool)
    for a, b in ranges.tolist():
        plane[a : b + 1] = True
    plane.setflags(write=False)
    return plane


@lru_cache(maxsize=1)
def kimi_classes() -> np.ndarray:
    """(0x110000,) uint8: ``classes`` with UC and LC cleared on Han (Kimi
    K2's word classes are ``[... && [^\\p{Han}]]``) and HAN set there."""
    classes, _ = get_tables()
    han = han_plane()
    out = np.where(han, (classes & ~np.uint8(UC | LC)) | np.uint8(HAN),
                   classes).astype(np.uint8)
    out.setflags(write=False)
    return out


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
# B_HAN): the six table classes (``let`` is the LETTER bit), the space,
# the apostrophe, the punctuation tail's class ([\r\n/]; [\r\n] under
# kimi), the four contraction-letter groups, and Han (kimi only).
CLASS_WORD_BITS = ("ws", "rn", "let", "num", "uc", "lc", "sp", "apo", "rnsl",
                   "g1", "grv", "ge", "gl", "han")
# contraction letters of each group: 's 't 'm 'd | 're 've | e | 'll
_FOLD_GROUPS = (("g1", "stmd"), ("grv", "rv"), ("ge", "e"), ("gl", "l"))
_PROFILES = ("llama4", "nocontract", "cl100k", "gpt2", "kimi")


@lru_cache(maxsize=5)
def char_class_words(profile: str) -> np.ndarray:
    """(0x110000,) uint16: bit i of entry cp is class ``CLASS_WORD_BITS[i]``
    of codepoint cp under ``profile``.

    The contraction groups hold each letter's full case-fold set for
    llama4, cl100k and kimi (the ``(?i:...)`` suffixes), the
    case-sensitive ASCII letters for gpt2, and nothing for nocontract.
    Under kimi the classes are ``kimi_classes()`` (no UC or LC on Han),
    ``rnsl`` leaves out "/" (its punctuation tail is ``[\\r\\n]*``) and
    ``han`` is set on Han; the other profiles never set ``han``. The first
    128 entries equal ``ops.bitplane.class_lut(profile)``. The table (2.2
    MB) replaces the JAX package's two-level page table and its row-gather
    lookup."""
    if profile not in _PROFILES:
        raise NotImplementedError(profile)
    classes, folds = get_tables()
    if profile == "kimi":
        classes = kimi_classes()
    c = classes.astype(np.uint16)
    bit = {name: np.uint16(1 << i) for i, name in enumerate(CLASS_WORD_BITS)}
    words = np.zeros(N_CP, np.uint16)
    for name, cls in (("ws", WS), ("rn", RN), ("let", LETTER), ("num", NUM),
                      ("uc", UC), ("lc", LC)):
        words |= np.where(c & cls, bit[name], np.uint16(0))
    words[ord(" ")] |= bit["sp"]
    words[ord("'")] |= bit["apo"]
    words |= np.where(c & RN, bit["rnsl"], np.uint16(0))
    if profile != "kimi":
        words[ord("/")] |= bit["rnsl"]
    else:
        words |= np.where(c & HAN, bit["han"], np.uint16(0))
    if profile != "nocontract":
        for name, letters in _FOLD_GROUPS:
            for L in letters:
                cps = [ord(L)] if profile == "gpt2" else folds[L]
                words[np.asarray(cps, np.int64)] |= bit[name]
    words.setflags(write=False)
    return words
