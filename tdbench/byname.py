"""The benchmark's parts, each a file found by its name.

``load(kind, name)`` imports ``tdbench/<kind>/<name>.py``: ``pools`` (text
makers), ``forms`` (what is done to a mix's texts), ``calls`` (the API
call one unit makes), ``loops`` (how the window drives the calls) and
``metrics`` (one reader a metric). A later cell or metric adds files and
entries, and edits none.
"""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
KINDS = ("pools", "forms", "calls", "loops", "metrics")


@functools.cache
def load(kind: str, name: str):
    if kind not in KINDS or not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*",
                                             name):
        raise ValueError(f"no {kind} part named {name!r}")
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind} part named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"tdbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str) -> list[str]:
    return sorted(p.stem for p in (HERE / kind).glob("*.py"))
