"""Form ``chat``: each text rendered as a chat of 1-4 turns, each a role
name and a share of the text cut at a seeded offset."""

from __future__ import annotations

import numpy as np

from tdbench.seeds import sub_seed

ROLES = ("System", "User", "Assistant", "User")


def render(body: str, seed: int) -> str:
    rng = np.random.default_rng([seed, 3])
    turns = int(rng.integers(1, 5))
    edges = np.sort(rng.integers(0, len(body) + 1, turns - 1)).tolist()
    parts, prev = [], 0
    for i, e in enumerate(edges + [len(body)]):
        parts.append(f"{ROLES[i]}: {body[prev:e]}\n\n")
        prev = e
    return "".join(parts)


def apply(texts: list[str], form: dict, seed: int) -> list[str]:
    return [render(t, sub_seed(seed, 1000 + i)) for i, t in enumerate(texts)]
