"""Pool ``code``: seeded source code (the benchmark's own maker)."""

from __future__ import annotations

import numpy as np

from tdbench.textgen import WORDS, cut

# identifier words of source code
IDENT_WORDS = (
    "get set is has add remove update create delete find load save read "
    "write open close parse format build make init reset start stop run "
    "handle process apply check validate convert compute count index value "
    "data buffer size length key item list map node tree graph edge user "
    "name id type kind mode state status config option file path dir stream "
    "token request response handler client server cache table row column "
    "query result error message event time date start end max min total "
    "offset limit batch queue task job worker pool thread lock context "
    "session account order price amount payment device model layer input "
    "output weight grad loss step epoch shard block page record entry field "
    "schema source target local remote default current next prev first last"
).split()
KEYWORDS = ("return", "if", "for", "while", "yield", "await", "else")
LITERALS = ('"utf-8"', "'%s: %d'", '"/api/v1/"', "None", "True", "False",
            "0", "1", "-1", "42", "3.14", "0x7f", "1e-6", "[]", "{}", '""')


def _ident(words: list[int], n: int, style: float) -> str:
    """A snake_case, camelCase or PascalCase identifier of the first
    ``n`` of ``words``."""
    w = [IDENT_WORDS[i] for i in words[:n]]
    if style < 0.4:
        return "_".join(w)
    if style < 0.8:
        return w[0] + "".join(x.capitalize() for x in w[1:])
    return "".join(x.capitalize() for x in w)


def make(n_bytes: int, seed: int) -> str:
    """About n_bytes of source code: lines of snake_case, camelCase and
    PascalCase identifiers of 1-4 words of ``IDENT_WORDS``, assignments,
    calls, definitions, conditions, literals and English comments, at
    indentations of 0-5 levels of four spaces or a tab, with blank lines
    between some. Draws are made a block of lines at a time."""
    rng = np.random.default_rng([seed, 2])
    lines, size, depth = [], 0, 0
    while size < n_bytes:
        n = 4096
        kind = rng.random(n).tolist()
        nw = rng.integers(1, 5, size=(n, 3)).tolist()
        ws = rng.integers(len(IDENT_WORDS), size=(n, 3, 4)).tolist()
        style = rng.random((n, 3)).tolist()
        lit = rng.integers(len(LITERALS), size=n).tolist()
        kw = rng.integers(len(KEYWORDS), size=n).tolist()
        ck = rng.integers(3, 14, n).tolist()
        cw = rng.integers(len(WORDS), size=(n, 13)).tolist()
        tab = (rng.random(n) < 0.1).tolist()
        dedent = rng.random(n).tolist()
        back = rng.random(n).tolist()
        blank = (rng.random(n) < 0.08).tolist()
        for i in range(n):
            a, b, c = (_ident(ws[i][j], nw[i][j], style[i][j])
                       for j in range(3))
            li, r = LITERALS[lit[i]], kind[i]
            if r < 0.30:
                s = f"{a} = {b}({c}, {li})"
            elif r < 0.45:
                s = f"{a}.{b} = {c}[{li}]"
            elif r < 0.55:
                s = f"def {a}(self, {b}, {c}={li}):"
            elif r < 0.60:
                s = f"class {a[:1].upper()}{a[1:]}({b}):"
            elif r < 0.72:
                s = f"{KEYWORDS[kw[i]]} {a}.{b}({c}) + {li}"
            elif r < 0.82:
                s = f"if {a} is not None and {b} > {li}:"
            elif r < 0.94:
                s = "# " + " ".join(WORDS[w] for w in cw[i][:ck[i]]) + "."
            else:
                s = f"{a}: {b}[{c}] = {{}}"
            s = ("\t" if tab[i] else "    ") * depth + s + "\n"
            if s.endswith(":\n"):
                depth = min(depth + 1, 5)
            elif dedent[i] < 0.25:
                depth = int(back[i] * (depth + 1))
            if blank[i]:
                s += "\n"
            lines.append(s)
            size += len(s)
            if size >= n_bytes:
                break
    return cut("".join(lines).encode(), n_bytes)

