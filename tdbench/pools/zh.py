"""Pool ``zh``: Chinese-English documents, blocks of 1-16 KB taken in turn,
three of seeded Chinese prose (``chinese``) for one of the ``prose`` pool.

This is seeded text, not a corpus: no Chinese text is in the repository or
on the card, so its statistics are drawn, not read. A clause is 2-12 words
of 1-4 Han characters, with no space between them; the characters are
drawn by Zipf's law (exponent 1) over a fixed-seed order of the CJK Unified
Ideographs U+4E00-U+9FFF, and about 0.3% come from Extensions A and B
instead; 々 (U+3005) and 〇 (U+3007) are rare. Clauses end in fullwidth
punctuation, "，" most often, then "。、；：？！"; some are wrapped in
“”, 「」, （） or 《》. About one clause in eight carries a Latin term or an
ASCII number ("2024", "3.5%", "GPU"), with spaces around it or without.
Paragraphs end in "\\n\\n". Every character is one that Unicode 15.0
assigns.
"""

from __future__ import annotations

import numpy as np

from tdbench.byname import load
from tdbench.textgen import cut

# the fixed order the Zipf ranks index, and its cumulative weights
_ORDER = np.random.default_rng(0x4E00).permutation(
    np.arange(0x4E00, 0xA000, dtype=np.uint32))
_CDF = np.cumsum(1.0 / np.arange(1, len(_ORDER) + 1))
_CDF /= _CDF[-1]
_EXT = np.concatenate([np.arange(0x3400, 0x4DC0), np.arange(0x20000, 0x2A6E0)]
                      ).astype(np.uint32)
_ENDS = list("，。、；：？！")
_ENDS_P = [0.55, 0.22, 0.08, 0.04, 0.04, 0.035, 0.035]
_WRAPS = ["“”", "「」", "（）", "《》"]
_TERMS = ["2024", "3.5%", "GPU", "API", "Linux", "H100", "AI", "100",
          "1.2", "PyTorch", "Transformer", "2025", "CPU", "OpenAI", "42",
          "HTTP"]
_WORD_LENS = [1, 2, 3, 4]
_WORD_LENS_P = [0.3, 0.45, 0.15, 0.1]


def chinese(n_bytes: int, seed: int) -> str:
    """About n_bytes of seeded Chinese prose (see the module doc)."""
    rng = np.random.default_rng([seed, 2])
    n_chars = n_bytes // 3 + 4096
    cps = _ORDER[np.searchsorted(_CDF, rng.random(n_chars))]
    rare = rng.random(n_chars)
    ext = rare < 0.003
    cps[ext] = _EXT[rng.integers(len(_EXT), size=int(ext.sum()))]
    cps[(rare >= 0.003) & (rare < 0.0035)] = ord("々")
    cps[(rare >= 0.0035) & (rare < 0.004)] = ord("〇")
    han = cps.astype("<u4").tobytes().decode("utf-32-le")
    parts, pos, size = [], 0, 0
    while size < n_bytes and pos < len(han) - 64:
        k = 1024
        n_words = rng.integers(2, 13, k).tolist()
        lens = rng.choice(_WORD_LENS, p=_WORD_LENS_P, size=(k, 12)).tolist()
        ends = rng.choice(len(_ENDS), p=_ENDS_P, size=k).tolist()
        r = rng.random((k, 4)).tolist()
        term = rng.integers(len(_TERMS), size=k).tolist()
        wrap = rng.integers(len(_WRAPS), size=k).tolist()
        for i in range(k):
            words = []
            for L in lens[i][:n_words[i]]:
                words.append(han[pos:pos + L])
                pos += L
            if r[i][0] < 1 / 8:  # a Latin term or an ASCII number
                t = _TERMS[term[i]]
                at = int(r[i][1] * (len(words) + 1))
                words.insert(at, f" {t} " if r[i][2] < 0.4 else t)
            s = "".join(words)
            if r[i][3] < 0.08:
                w = _WRAPS[wrap[i]]
                s = w[0] + s + w[1]
            s += _ENDS[ends[i]]
            if ends[i] in (1, 5, 6) and r[i][3] > 0.8:
                s += "\n\n"
            parts.append(s)
            size += len(s.encode())
            if size >= n_bytes or pos >= len(han) - 64:
                break
    return "".join(parts)


def make(n_bytes: int, seed: int) -> str:
    """About n_bytes of documents."""
    rng = np.random.default_rng([seed, 1])
    zh = chinese(n_bytes * 4 // 5 + (64 << 10), seed).encode()
    en = load("pools", "prose").make(n_bytes * 3 // 10 + (32 << 10),
                                     seed + 1).encode()
    parts, pos, size = [], [0, 0], 0
    while size < n_bytes:
        for j in (0, 0, 0, 1):
            src = (zh, en)[j]
            k = int(rng.integers(1 << 10, 16 << 10))
            parts.append(src[pos[j]:pos[j] + k])
            pos[j] += k
            size += k
    return cut(b"".join(parts), n_bytes)
