"""Named-encoding registry (tiktoken's ``get_encoding`` convenience).

A name maps to a loader over local files. Applications register their
own:

    tt.register_encoding("my-llama", vocab_file=..., config_file=...)
    enc = tt.get_encoding("my-llama")

Built-ins:
  - "llama4": Llama-4/o200k pattern; vocab from $TOKENDAGGER_LLAMA4_MODEL
    (tiktoken .model format) + optional $TOKENDAGGER_LLAMA4_CONFIG
    (HF config for specials).
  - "tekken": Mistral Tekken; $TOKENDAGGER_TEKKEN_JSON.
  - the standard tiktoken names ("cl100k_base", "o200k_base", "gpt2",
    "r50k_base", "p50k_base"): built from tiktoken's own vocab data when
    tiktoken is installed and can supply it; otherwise ``get_encoding``
    raises ``ValueError``.

Loaders build port ``Tokenizer``s with their defaults: the device backend
on the card. A custom ``loader`` chooses its own backend and device.
"""

from __future__ import annotations

import functools
import os
import threading
from pathlib import Path
from typing import Callable

from .wrapper import Tokenizer

_LOCK = threading.Lock()
_REGISTRY: dict[str, Callable[[], Tokenizer]] = {}
_CACHE: dict[str, Tokenizer] = {}


def register_encoding(
    name: str,
    *,
    loader: Callable[[], Tokenizer] | None = None,
    vocab_file: str | Path | None = None,
    config_file: str | Path | None = None,
    tekken_file: str | Path | None = None,
    pattern: str | None = None,
) -> None:
    """Register a named encoding: either a custom ``loader`` callable or
    file paths (tiktoken .model + optional HF config, or a tekken.json)."""
    if loader is None:
        if tekken_file is not None:
            loader = functools.partial(_load_tekken_file, name,
                                       Path(tekken_file))
        elif vocab_file is not None:
            loader = functools.partial(
                _load_model_file, name, Path(vocab_file),
                Path(config_file) if config_file else None, pattern)
        else:
            raise ValueError(
                "register_encoding needs loader=, vocab_file= or tekken_file=")
    with _LOCK:
        _REGISTRY[name] = loader
        _CACHE.pop(name, None)


def get_encoding(name: str) -> Tokenizer:
    """Resolve a registered (or built-in) encoding name to a Tokenizer."""
    with _LOCK:
        tok = _CACHE.get(name)
        if tok is not None:
            return tok
        loader = _REGISTRY.get(name)
    if loader is None:
        loader = _builtin_loader(name)
        if loader is None:
            raise ValueError(
                f"Unknown encoding {name!r}; register it with "
                "register_encoding()")
    tok = loader()
    with _LOCK:
        _CACHE[name] = tok
    return tok


def list_encodings() -> list[str]:
    """Registered names, and the built-ins whose env var is set."""
    with _LOCK:
        names = set(_REGISTRY)
    for name, env in (("llama4", "TOKENDAGGER_LLAMA4_MODEL"),
                      ("tekken", "TOKENDAGGER_TEKKEN_JSON")):
        if os.environ.get(env):
            names.add(name)
    return sorted(names)


# ----------------------------------------------------------------------
def _load_model_file(name, vocab_file, config_file, pattern) -> Tokenizer:
    from . import vocab as v

    ranks = v.load_tiktoken_model(vocab_file)
    specials = v.load_hf_special_tokens(config_file) if config_file else {}
    return Tokenizer(name, pattern=pattern or v.LLAMA4_PATTERN,
                     mergeable_ranks=ranks, special_tokens=specials)


def _load_tekken_file(name, tekken_file) -> Tokenizer:
    from . import vocab as v

    cfg = v.load_tekken(tekken_file)
    return Tokenizer(name, pattern=cfg["pattern"],
                     mergeable_ranks=cfg["mergeable_ranks"],
                     special_tokens=cfg["special_tokens"])


_TIKTOKEN_NAMES = frozenset(
    ("cl100k_base", "o200k_base", "gpt2", "r50k_base", "p50k_base"))


def _load_via_tiktoken(name: str) -> Tokenizer:
    """A standard encoding from tiktoken's own vocab data, which tiktoken
    reads from its cache or fetches itself."""
    try:
        import tiktoken

        tk = tiktoken.get_encoding(name)
    except Exception as e:  # noqa: BLE001 - no tiktoken, cache or network
        raise ValueError(
            f"Encoding {name!r} needs tiktoken's vocab data, which could "
            f"not be loaded ({type(e).__name__}: {e}). Register the "
            "vocabulary from local files with register_encoding()."
        ) from e
    return Tokenizer(name, pattern=tk._pat_str,
                     mergeable_ranks=tk._mergeable_ranks,
                     special_tokens=tk._special_tokens)


def _builtin_loader(name: str):
    if name == "llama4":
        model = os.environ.get("TOKENDAGGER_LLAMA4_MODEL")
        if model:
            cfg = os.environ.get("TOKENDAGGER_LLAMA4_CONFIG")
            return functools.partial(
                _load_model_file, name, Path(model),
                Path(cfg) if cfg else None, None)
    if name == "tekken":
        tj = os.environ.get("TOKENDAGGER_TEKKEN_JSON")
        if tj:
            return functools.partial(_load_tekken_file, name, Path(tj))
    if name in _TIKTOKEN_NAMES:
        return functools.partial(_load_via_tiktoken, name)
    return None
