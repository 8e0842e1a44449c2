"""Seeded text shared by the pools (``pools/*.py``).

``corpus`` and ``multiscript`` are frozen copies of the generators of the
repository's ``chip_smoke.py`` (word lists included), so that the
benchmark's inputs do not move when that script does. Every function is a
pure function of its arguments: the same seed gives the same text.
"""

from __future__ import annotations

import numpy as np

WORDS = (
    "the of and to in a is that for it as was with be by on not he this are "
    "or his from at which but have an they you were her she all would there "
    "their we him been has when who will no more if out so said what up its "
    "about into than them can only other new some could time these two may "
    "then do first any my now such like our over man me even most made after "
    "also did many before must through back years where much your way well "
    "down should because each just those people Mr how too little state good "
    "very make world still own see men work long get here between both life "
    "being under never day same another know while last might us great old "
    "year off come since against go came right used take three"
).split()
CODE = [
    "    def f(x):\n        return x**2\n",
    "for (int i = 0; i < n; ++i) { a[i] += b[i]; }\n",
    "    if err != nil {\n        return err\n    }\n",
    "x = [1, 2, 3]  # list\n",
    "<div class=\"row\">{{ item.name }}</div>\n",
]


def corpus(n_bytes: int, seed: int) -> str:
    """English-like sentences with numbers and code lines (ASCII): the
    recipe of ``chip_smoke.corpus`` (6-19 words a sentence, a number in
    15%, contractions in 10%, a code line after 5%), its draws made a
    block of sentences at a time."""
    rng = np.random.default_rng(seed)
    ends = [". ", "! ", "? ", ".\n\n"]
    parts, size = [], 0
    while size < n_bytes:
        n = 4096
        k = rng.integers(6, 20, n).tolist()
        words = rng.integers(len(WORDS), size=(n, 19)).tolist()
        r = rng.random(n).tolist()
        num = rng.integers(0, 10**7, n).tolist()
        end = rng.integers(4, size=n).tolist()
        with_code = (rng.random(n) < 0.05).tolist()
        line = rng.integers(len(CODE), size=n).tolist()
        for i in range(n):
            s = " ".join(WORDS[w] for w in words[i][:k[i]]).capitalize()
            if r[i] < 0.15:
                s += f" {num[i]}"
            elif r[i] < 0.25:
                s += " don't they'll I'm"
            s += ends[end[i]]
            if with_code[i]:
                s += CODE[line[i]]
            parts.append(s)
            size += len(s)
            if size >= n_bytes:
                break
    return "".join(parts)[:n_bytes]


# multi-script words: Latin accents, Greek, Cyrillic, CJK, Arabic, Hebrew,
# emoji (ZWJ, skin tone, flags), combining marks, other digits, and the
# fold letters U+017F / U+212A after apostrophes
SCRIPT_WORDS = (
    "café naïve Übermäßig schön Ça résumé ÉCOLE ǅemal Γειά σου Κόσμε ΑΘΗΝΑ "
    "λόγος Здравствуйте мир МОСКВА ёлка 日本語 中文文本 テキスト 한국어 の "
    "مرحبا שלום עולם 🙂 👍🏽 🇺🇸 🎉🎉 e\u0301\u0302 à a\u0308 ٣٤ ²³ Ⅻ "
    "I'\u017fT x'\u212a it'\u017f \u3000x"
).split(" ") + ["👩\u200d👩\u200d👧", "\u3000", "\u3000\u3000", "\u00a0"]
SEPARATORS = [" ", " ", " ", " ", ", ", ". ", "\n", "\u3000", "'s ",
              "'LL ", " 12 ", "! ", "\n\n", " - "]


def multiscript(n_bytes: int, seed: int) -> str:
    """About n_bytes of seeded text: the English word list and the
    multi-script words, mixed, with punctuation, digits and contractions."""
    rng = np.random.default_rng(seed)
    words = WORDS + SCRIPT_WORDS
    parts, size = [], 0
    while size < n_bytes:
        k = 1 << 16
        w = rng.integers(len(words), size=k)
        sp = rng.integers(len(SEPARATORS), size=k)
        chunk = "".join(words[i] + SEPARATORS[j] for i, j in zip(w, sp))
        parts.append(chunk)
        size += len(chunk.encode())
    raw = "".join(parts).encode()[:n_bytes]
    return raw.decode("utf-8", errors="ignore")



def cut(raw: bytes, n_bytes: int) -> str:
    """The first n_bytes of ``raw``, less a split character at the end."""
    return raw[:n_bytes].decode("utf-8", errors="ignore")

