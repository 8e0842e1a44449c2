"""Form ``fim``: every ``nth`` text made a fill-in-the-middle sample, cut
at two seeded offsets into prefix, middle and suffix and laid out as
``tokens`` [prefix, suffix, middle] + prefix + suffix + middle."""

from __future__ import annotations

import numpy as np

from tdbench.seeds import sub_seed


def apply(texts: list[str], form: dict, seed: int) -> list[str]:
    rng = np.random.default_rng(sub_seed(seed, 21))
    pre, suf, mid = form["tokens"]
    out = []
    for i, s in enumerate(texts):
        if i % int(form["nth"]) == 0:
            a, b = sorted(rng.integers(0, len(s) + 1, 2).tolist())
            s = pre + s[:a] + suf + s[b:] + mid + s[a:b]
        out.append(s)
    return out
