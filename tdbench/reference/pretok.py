"""The benchmark's own pretokenizer: a published ``pat_str`` run by ``re``.

tiktoken's patterns use Unicode property classes (``\\p{L}``, ``\\p{Lu}``,
...), which Python's ``re`` lacks. ``translate`` writes each one out as an
explicit character class built from ``unicodedata`` categories, and
``\\s``/``\\S`` as the Unicode White_Space set; ``re`` compiles the result
(Python 3.11 and later read possessive quantifiers).

``re`` tests a character against a class's ranges above U+FFFF one by one,
after its bitmap of the BMP, so a class holding them all is ~9x slower on
any text. So the classes hold BMP ranges only, plus one stand-in code
point from the private use area for each category of the supplementary
planes (``PROXY``): ``split`` matches a copy of the text in which every
supplementary character is replaced by its category's stand-in (and any
stand-in code point already in the text by U+E000, which is in no class),
and cuts the original text at the same offsets. The replacement keeps
every character's class, so the pieces are those of the published
pattern. Nothing here comes from the program under test.
"""

from __future__ import annotations

import functools
import re
import unicodedata

# The Unicode White_Space property (PropList.txt), which ``\s`` means in
# the regex engines tiktoken's patterns were written for; all in the BMP.
WHITE_SPACE = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f"
    "\u3000")

# a supplementary character's category -> its stand-in in the BMP
PROXY = {"Lu": "\ue001", "Ll": "\ue002", "Lt": "\ue003", "Lm": "\ue004",
         "Lo": "\ue005", "M": "\ue006", "N": "\ue007"}
NO_CLASS = "\ue000"
_OUTSIDE = re.compile("[\U00010000-\U0010ffff\ue001-\ue007]")

_PROPERTIES = ("L", "Lu", "Ll", "Lt", "Lm", "Lo", "M", "N")


@functools.cache
def _members() -> dict[str, str]:
    """Each property name -> the body of a character class: its BMP
    ranges and the stand-ins of its supplementary categories."""
    runs: dict[str, list[list[int]]] = {p: [] for p in _PROPERTIES}
    for cp in range(0x10000):
        cat = unicodedata.category(chr(cp))
        for p in (cat, cat[0]):
            if p in runs:
                r = runs[p]
                if r and r[-1][1] == cp - 1:
                    r[-1][1] = cp
                else:
                    r.append([cp, cp])
    out = {}
    for p, r in runs.items():
        body = "".join(
            re.escape(chr(a)) if a == b
            else f"{re.escape(chr(a))}-{re.escape(chr(b))}" for a, b in r)
        out[p] = body + "".join(v for k, v in PROXY.items()
                                if k.startswith(p) or p.startswith(k))
    return out


def _proxy(m: re.Match) -> str:
    cat = unicodedata.category(m.group(0))
    return PROXY.get(cat, PROXY.get(cat[0], NO_CLASS)) if (
        ord(m.group(0)) > 0xFFFF) else NO_CLASS


_TOKEN = re.compile(r"\\p\{(\w+)\}|\\s|\\S|\\.|\[|\]|.", re.S)


def translate(pat_str: str) -> str:
    """``pat_str`` with every ``\\p{X}``, ``\\s`` and ``\\S`` written out
    for ``re``, inside and outside brackets."""
    members = _members()
    out, in_class = [], False
    for m in _TOKEN.finditer(pat_str):
        tok = m.group(0)
        if m.group(1):
            if m.group(1) not in members:
                raise ValueError(f"unknown property {tok}")
            body = members[m.group(1)]
            out.append(body if in_class else f"[{body}]")
        elif tok == r"\s":
            out.append(WHITE_SPACE if in_class else f"[{WHITE_SPACE}]")
        elif tok == r"\S":
            if in_class:
                raise ValueError(r"\S inside a class is not supported")
            out.append(f"[^{WHITE_SPACE}]")
        elif tok == "[" and not in_class:
            in_class = True
            out.append(tok)
        elif tok == "]" and in_class:
            in_class = False
            out.append(tok)
        else:
            out.append(tok)
    return "".join(out)


@functools.cache
def compile_pattern(pat_str: str) -> re.Pattern:
    return re.compile(translate(pat_str))


def split(pat_str: str, text: str) -> list[str]:
    """The pretokens of ``text``: every match of the pattern, in order."""
    pattern = compile_pattern(pat_str)
    if _OUTSIDE.search(text) is None:
        return pattern.findall(text)
    mapped = _OUTSIDE.sub(_proxy, text)
    return [text[m.start():m.end()] for m in pattern.finditer(mapped)]
