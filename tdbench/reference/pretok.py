"""The benchmark's own pretokenizer: a published ``pat_str`` run by ``re``.

tiktoken's patterns use Unicode property classes (``\\p{L}``, ``\\p{Lu}``,
...), which Python's ``re`` lacks. ``translate`` writes each one out as an
explicit character class built from ``unicodedata`` categories (Unicode
15.0.0 under Python 3.12), and ``\\s``/``\\S`` as the Unicode White_Space
set; ``re`` compiles the result (Python 3.11 and later read possessive
quantifiers). What it reads:

* ``\\p{X}`` for the categories L, Lu, Ll, Lt, Lm, Lo, M and N, and for
  the script Han (``scripts.HAN``: the Han code points that Unicode 15.0
  assigns), inside and outside brackets; ``\\s`` anywhere, ``\\S``
  outside brackets;
* a class intersected with one nested class, ``[A&&[B]]`` or
  ``[A&&[^B]]`` (the outer class may be negated too), with the meaning it
  has in tiktoken's engine and in ``regex`` V1: ``&&`` binds looser than
  the union of A's items. It is written out as one explicit class of the
  BMP code points in both (a literal above U+FFFF in A or B is refused);
* everything else, which is passed to ``re`` as it stands.

Refused with ``ValueError`` rather than guessed: ``\\P{X}``, any property
not listed above, the set operators ``--``, ``||`` and ``~~``, a ``[``
inside a class other than right after ``&&``, ``&&`` outside a class or
not followed by a nested class, nesting deeper than one level, items after
the nested class, and ``&&`` in a case-insensitive group.

``re`` tests a character against a class's ranges above U+FFFF one by one,
after its bitmap of the BMP, so a class holding them all is ~9x slower on
any text. So the classes hold BMP ranges only, plus stand-in code points
from the private use area for the supplementary planes: ``split`` matches
a copy of the text in which every supplementary character is replaced by
its stand-in (and any stand-in code point already in the text by U+E000,
which is in no class), and cuts the original text at the same offsets.
There is one stand-in for each category group of ``PROXY`` (and U+E000
for a character in none), as before Han was read; where the pattern names
``\\p{Han}``, Han characters get stand-ins of their own, one for each
category group (``HAN_PROXY``, U+E008-E00F), so that a Han Lo of CJK
Extension B and a Tangut Lo part there. The replacement keeps every
character's membership of every property the pattern names, so the pieces
are those of the published pattern. Nothing here comes from the program
under test, and ``regex`` is not imported.
"""

from __future__ import annotations

import bisect
import functools
import re
import unicodedata

from .scripts import HAN

# The Unicode White_Space property (PropList.txt), which ``\s`` means in
# the regex engines tiktoken's patterns were written for; all in the BMP.
WHITE_SPACE = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f"
    "\u3000")

# a supplementary character's category -> its stand-in in the BMP
PROXY = {"Lu": "\ue001", "Ll": "\ue002", "Lt": "\ue003", "Lm": "\ue004",
         "Lo": "\ue005", "M": "\ue006", "N": "\ue007"}
NO_CLASS = "\ue000"
# a supplementary Han character's category group (None: in none) -> its
# stand-in, used only where the pattern names \p{Han}
HAN_PROXY = {g: chr(0xE008 + i) for i, g in enumerate((*PROXY, None))}
_OUTSIDE = re.compile("[\U00010000-\U0010ffff\ue001-\ue00f]")

_PROPERTIES = ("L", "Lu", "Ll", "Lt", "Lm", "Lo", "M", "N")
_HAN_STARTS = [a for a, _ in HAN]


def _group(cat: str) -> str | None:
    return cat if cat in PROXY else cat[0] if cat[0] in PROXY else None


def _in_han(cp: int) -> bool:
    i = bisect.bisect_right(_HAN_STARTS, cp) - 1
    return i >= 0 and cp <= HAN[i][1]


def _runs(cps) -> list[list[int]]:
    """Sorted code points -> inclusive runs."""
    runs: list[list[int]] = []
    for cp in cps:
        if runs and runs[-1][1] == cp - 1:
            runs[-1][1] = cp
        else:
            runs.append([cp, cp])
    return runs


def _body(runs) -> str:
    return "".join(
        re.escape(chr(a)) if a == b
        else f"{re.escape(chr(a))}-{re.escape(chr(b))}" for a, b in runs)


@functools.cache
def _members(han: bool) -> dict[str, str]:
    """Each property name -> the body of a character class: its BMP
    ranges and the stand-ins of its supplementary characters; ``Han``
    and the Han stand-ins only where ``han`` (the pattern names it)."""
    cps: dict[str, list[int]] = {p: [] for p in _PROPERTIES}
    for cp in range(0x10000):
        cat = unicodedata.category(chr(cp))
        for p in (cat, cat[0]):
            if p in cps:
                cps[p].append(cp)
    proxies = [*PROXY.items(), *(HAN_PROXY.items() if han else ())]
    out = {p: _body(_runs(c)) + "".join(
        v for g, v in proxies if g is not None and g.startswith(p))
        for p, c in cps.items()}
    if han:
        out["Han"] = _body(r for r in HAN if r[1] <= 0xFFFF) + "".join(
            HAN_PROXY.values())
    return out


_TOKEN = re.compile(
    r"\\([pP])\{(\w+)\}|\\[pP]|\\s|\\S|\\.|&&|--|\|\||~~|\[|\]|.", re.S)
# the flags of a group that opens at "(": (?i:...), (?-i:...), (?i)
_FLAGS = re.compile(r"\?([a-zA-Z]*)(?:-([a-zA-Z]*))?([:)])")


def _property(m: re.Match, members: dict[str, str]) -> str:
    tok = m.group(0)
    if m.group(1) != "p" or m.group(2) not in members:
        raise ValueError(f"unknown property {tok}")
    return members[m.group(2)]


def _items(toks: list, j: int, members: dict[str, str]):
    """A class's items from ``toks[j]`` up to its ``]`` or ``&&``, each
    written out for ``re``: (the items, the literal ones among them, the
    index of that token)."""
    items, literal = [], []
    while True:
        if j == len(toks):
            raise ValueError("a class is not closed")
        m = toks[j]
        tok = m.group(0)
        if tok in ("]", "&&"):
            return items, literal, j
        if tok == "[":
            raise ValueError("a [ inside a class is read only right after &&")
        if tok in ("--", "||", "~~"):
            raise ValueError(f"the set operator {tok} is not supported")
        if tok.startswith(("\\p", "\\P")):
            items.append(_property(m, members))
        elif tok == r"\s":
            items.append(WHITE_SPACE)
        elif tok == r"\S":
            raise ValueError(r"\S inside a class is not supported")
        else:
            items.append(tok)
            literal.append(tok)
        j += 1


@functools.cache
def _bmp() -> str:
    return "".join(map(chr, range(0x10000)))


@functools.cache
def _supplementary() -> str:
    return "".join(map(chr, range(0x10000, 0x110000)))


def _chars(body: str, negate: bool) -> set[int]:
    """The BMP code points in the class ``[body]`` (or ``[^body]``)."""
    return {ord(c) for c in re.findall(f"[{'^' * negate}{body}]", _bmp())}


def _class(toks: list, i: int, members: dict[str, str], ignore_case: bool):
    """The class that opens at ``toks[i]`` written out for ``re``: (its
    text, the index of the token after it)."""
    j = i + 1
    negate = j < len(toks) and toks[j].group(0) == "^"
    left, lit, j = _items(toks, j + negate, members)
    if toks[j].group(0) == "]":
        return "[" + "^" * negate + "".join(left) + "]", j + 1
    if ignore_case:
        raise ValueError("&& in a case-insensitive group is not supported")
    if not left:
        raise ValueError("&& with nothing before it")
    if j + 1 == len(toks) or toks[j + 1].group(0) != "[":
        raise ValueError("&& is read only before a nested class")
    k = j + 2
    inner_negate = k < len(toks) and toks[k].group(0) == "^"
    right, lit2, k = _items(toks, k + inner_negate, members)
    if toks[k].group(0) == "&&":
        raise ValueError("classes nested deeper than one level")
    if not right:
        raise ValueError("an empty nested class")
    k += 1
    if k == len(toks) or toks[k].group(0) != "]":
        raise ValueError("items after a nested class")
    # a property's characters above U+FFFF are its stand-ins; a literal's
    # would be lost from the BMP class written out
    if lit + lit2 and re.search(f"[{''.join(lit + lit2)}]", _supplementary()):
        raise ValueError("a literal above U+FFFF in an intersected class")
    cps = (_chars("".join(left), False)
           & _chars("".join(right), inner_negate))
    return "[" + "^" * negate + _body(_runs(sorted(cps))) + "]", k + 1


@functools.cache
def _translate(pat_str: str) -> tuple[str, bool]:
    """(``pat_str`` written out for ``re``, whether it names Han)."""
    toks = list(_TOKEN.finditer(pat_str))
    han = any(m.group(2) == "Han" for m in toks)
    members = _members(han)
    out, i = [], 0
    ignore_case = [False]     # of each open group, outermost first
    while i < len(toks):
        m = toks[i]
        tok = m.group(0)
        if tok == "[":
            text, i = _class(toks, i, members, ignore_case[-1])
            out.append(text)
            continue
        i += 1
        if tok.startswith(("\\p", "\\P")):
            out.append(f"[{_property(m, members)}]")
        elif tok == r"\s":
            out.append(f"[{WHITE_SPACE}]")
        elif tok == r"\S":
            out.append(f"[^{WHITE_SPACE}]")
        elif tok == "&&":
            raise ValueError("&& outside a class")
        else:
            out.append(tok)
        if tok == "(":
            on = ignore_case[-1]
            f = _FLAGS.match(pat_str, m.end())
            if f and "i" in f.group(1):
                on = True
            if f and "i" in (f.group(2) or ""):
                on = False
            if f and f.group(3) == ")":     # (?i): the whole pattern
                ignore_case[0] = on
            ignore_case.append(on)
        elif tok == ")" and len(ignore_case) > 1:
            ignore_case.pop()
    return "".join(out), han


def translate(pat_str: str) -> str:
    """``pat_str`` with every ``\\p{X}``, ``\\s``, ``\\S`` and class
    intersection written out for ``re``, inside and outside brackets."""
    return _translate(pat_str)[0]


def _proxy(han: bool, m: re.Match) -> str:
    ch = m.group(0)
    cp = ord(ch)
    if cp <= 0xFFFF:
        return NO_CLASS
    group = _group(unicodedata.category(ch))
    if han and _in_han(cp):
        return HAN_PROXY[group]
    return PROXY.get(group, NO_CLASS)


@functools.cache
def compile_pattern(pat_str: str):
    """(the compiled pattern, the stand-in of a supplementary match)."""
    text, han = _translate(pat_str)
    return re.compile(text), functools.partial(_proxy, han)


def split(pat_str: str, text: str) -> list[str]:
    """The pretokens of ``text``: every match of the pattern, in order."""
    pattern, proxy = compile_pattern(pat_str)
    if _OUTSIDE.search(text) is None:
        return pattern.findall(text)
    mapped = _OUTSIDE.sub(proxy, text)
    return [text[m.start():m.end()] for m in pattern.finditer(mapped)]
