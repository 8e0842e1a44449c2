"""Pool ``prose``: documents, blocks of 1-16 KB taken in turn from
``multiscript`` and ``corpus`` text."""

from __future__ import annotations

import numpy as np

from tdbench.textgen import corpus, cut, multiscript


def make(n_bytes: int, seed: int) -> str:
    """About n_bytes of documents."""
    rng = np.random.default_rng([seed, 1])
    a = multiscript(n_bytes // 2 + (16 << 10), seed).encode()
    b = corpus(n_bytes // 2 + (16 << 10), seed + 1).encode()
    parts, pos, size = [], [0, 0], 0
    while size < n_bytes:
        for j, src in enumerate((a, b)):
            k = int(rng.integers(1 << 10, 16 << 10))
            parts.append(src[pos[j]:pos[j] + k])
            pos[j] += k
            size += k
    return cut(b"".join(parts), n_bytes)

