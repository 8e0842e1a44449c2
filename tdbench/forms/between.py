"""Form ``between``: each text cut into sub-documents of about ``every``
bytes (0.75-1.25 x, seeded), joined by ``token``."""

from __future__ import annotations

import numpy as np

from tdbench.seeds import sub_seed
from tdbench.textgen import cut


def apply(texts: list[str], form: dict, seed: int) -> list[str]:
    rng = np.random.default_rng(sub_seed(seed, 21))
    every, out = int(form["every"]), []
    for s in texts:
        t, parts, pos = s.encode("utf-8"), [], 0
        while pos < len(t):
            k = int(every * rng.uniform(0.75, 1.25))
            parts.append(cut(t[pos:pos + k], k))
            pos += k
        out.append(form["token"].join(parts))
    return out
