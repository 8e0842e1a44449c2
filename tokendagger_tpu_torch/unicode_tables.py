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
