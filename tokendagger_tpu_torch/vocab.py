"""Vocabulary & config loaders.

The pretokenizer patterns, their profile classification, and two of the
on-disk formats the reference framework consumes (see reference behavior:
src/main.cpp:89-137):

1. tiktoken ``.model`` files: lines of ``base64(token_bytes) rank``.
2. HuggingFace ``tokenizer_config.json``: special tokens from
   ``added_tokens_decoder[id].content``.
3. Mistral Tekken ``tekken.json`` (``load_tekken``).

All loaders return plain Python data (``dict[bytes, int]`` etc.).
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Any

# The Llama-4 (o200k-family) pretokenizer pattern, hardcoded by the reference
# command-line tool (src/main.cpp:114) and its conformance test
# (tests/test_tokendagger_vs_tiktoken.py:40).
LLAMA4_PATTERN = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
    r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
    r"|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n/]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)


# The same family without the contraction alternates (Mistral Tekken's
# pattern, see src/mistral_main.cpp and the Tekken config
# convention described at
# tests/test_tokendagger_vs_tiktoken.py:61-77).
TEKKEN_PATTERN = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n/]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)

# The cl100k_base (GPT-4) pattern — possessive quantifiers and a leading
# contraction alternative (tiktoken's cl100k_base pat_str).
CL100K_PATTERN = (
    r"'(?i:[sdmt]|ll|ve|re)"
    r"|[^\r\n\p{L}\p{N}]?+\p{L}+"
    r"|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]++[\r\n]*"
    r"|\s*[\r\n]"
    r"|\s+(?!\S)"
    r"|\s+"
)

# The gpt2 / r50k_base / p50k_base pattern (tiktoken's original family):
# case-SENSITIVE contractions, optional-space word/number/punct runs,
# unbounded digit runs.
GPT2_PATTERN = (
    r"'(?:[sdmt]|ll|ve|re)"
    r"| ?\p{L}+"
    r"| ?\p{N}+"
    r"| ?[^\s\p{L}\p{N}]+"
    r"|\s+(?!\S)"
    r"|\s+"
)

_CONTRACTION_GROUP = r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?"


def classify_pattern(pattern: str) -> str | None:
    """Recognize patterns the accelerated scanners support.

    Returns "llama4" (o200k family with contraction alternates),
    "nocontract" (same family without them, e.g. Tekken), "cl100k"
    (GPT-4 family), or None (unsupported — engines fall back to the host
    regex split, still exact)."""
    if pattern == LLAMA4_PATTERN:
        return "llama4"
    if pattern == TEKKEN_PATTERN:
        return "nocontract"
    if pattern == CL100K_PATTERN:
        return "cl100k"
    if pattern == GPT2_PATTERN:
        return "gpt2"
    # normalize: removing the contraction group from a llama4-family
    # pattern must yield the no-contraction canon
    if pattern.replace(_CONTRACTION_GROUP, "") == TEKKEN_PATTERN:
        return "llama4"
    return None


def load_tiktoken_model(path: str | Path) -> dict[bytes, int]:
    """Parse a tiktoken ``.model``/``.tiktoken`` file into mergeable ranks.

    Format: one ``base64 rank`` pair per line (reference parser:
    src/main.cpp:89-110).
    """
    ranks: dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            b64, rank_s = line.split()
            ranks[base64.b64decode(b64)] = int(rank_s)
    return ranks


def load_hf_special_tokens(path: str | Path) -> dict[str, int]:
    """Extract special tokens from a HF ``tokenizer_config.json``.

    Reads ``added_tokens_decoder: {"<id>": {"content": "<token>"}}``
    (reference: src/main.cpp:121-133).
    """
    with open(path, "r", encoding="utf-8") as f:
        config = json.load(f)
    out: dict[str, int] = {}
    for id_str, entry in config.get("added_tokens_decoder", {}).items():
        out[entry["content"]] = int(id_str)
    return out


def load_tekken(
    path: str | Path,
    *,
    include_special_tokens: bool = True,
) -> dict[str, Any]:
    """Load a Mistral Tekken ``tekken.json``.

    Applies the Tekken rank convention: the first
    ``default_num_special_tokens`` ids are specials; ordinary vocab entry
    ``i`` (for ``i < default_vocab_size - default_num_special_tokens``)
    maps to rank ``i + default_num_special_tokens``.

    Returns ``{"pattern": str, "mergeable_ranks": dict[bytes,int],
    "special_tokens": dict[str,int], "config": dict}``.
    """
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    cfg = data["config"]
    num_special = cfg["default_num_special_tokens"]
    max_vocab = cfg["default_vocab_size"] - num_special

    ranks: dict[bytes, int] = {}
    for i, item in enumerate(data["vocab"]):
        if i >= max_vocab:
            break
        ranks[base64.b64decode(item["token_bytes"])] = i + num_special

    special_tokens: dict[str, int] = {}
    if include_special_tokens:
        for item in data.get("special_tokens", []):
            special_tokens[item["token_str"]] = item["rank"]

    return {
        "pattern": cfg["pattern"],
        "mergeable_ranks": ranks,
        "special_tokens": special_tokens,
        "config": cfg,
    }


def vocab_list_to_ranks(vocab: list[dict]) -> dict[bytes, int]:
    """Convert the list-of-dicts vocab format (``{"rank": int,
    "token_bytes": list[int] | str, "token_string": str}``) to mergeable
    ranks."""
    ranks: dict[bytes, int] = {}
    for item in vocab:
        tb = item["token_bytes"]
        if isinstance(tb, list):
            tb = bytes(tb)
        elif isinstance(tb, str):
            tb = tb.encode("utf-8")
        ranks[tb] = item["rank"]
    return ranks


def ranks_to_vocab_list(ranks: dict[bytes, int]) -> list[dict]:
    """Inverse of :func:`vocab_list_to_ranks` (for API compat)."""
    return [
        {"rank": rank, "token_bytes": list(tb), "token_string": ""}
        for tb, rank in ranks.items()
    ]
