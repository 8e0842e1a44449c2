"""The stand-in vocabulary of a configuration, made from ``--seed``.

No published vocabulary file is in the repository or on the card, so a
configuration is the published *shape* of one (its ``pat_str``, its count
of mergeable ranks and its specials) and the tokens are made here, as
``chip_smoke.standin_vocab`` makes its own, but split by the benchmark's
own pretokenizer (``reference/pretok``):

1. the 256 single bytes, ranks 0-255;
2. every byte prefix (two bytes and longer) of every distinct pretoken of a
   seeded training sample, in order of first appearance: prose and code
   from this benchmark's pools (``pools/``), of the sizes the
   configuration's ``assumed.sample_bytes`` states;
3. seeded printable ASCII strings of 2-16 bytes, up to the published count.

So common pieces of prose are whole tokens, while identifiers composed
anew mostly are not and merge, as against a trained vocabulary.
"""

from __future__ import annotations

import numpy as np

from .reference import pretok
from .seeds import sub_seed
from .byname import load


def standin_ranks(config: dict, seed: int) -> dict[bytes, int]:
    n_ranks = int(config["n_mergeable_ranks"])
    ranks = {bytes([i]): i for i in range(256)}
    for j, (pool, n_bytes) in enumerate(
            config["assumed"]["sample_bytes"].items()):
        sample = load("pools", pool).make(int(n_bytes),
                                           sub_seed(seed, 10 + j))
        for piece in dict.fromkeys(pretok.split(config["pat_str"], sample)):
            p = piece.encode("utf-8")
            for k in range(2, len(p) + 1):
                ranks.setdefault(p[:k], len(ranks))
    if len(ranks) > n_ranks:
        raise ValueError(f"the training sample alone gives {len(ranks)} "
                         f"tokens, more than the {n_ranks} published")
    rng = np.random.default_rng(sub_seed(seed, 19))
    while len(ranks) < n_ranks:
        lens = rng.integers(2, 17, 1 << 16).tolist()
        pool = rng.integers(32, 127, 16 << 16).astype(np.uint8).tobytes()
        for i, k in enumerate(lens):
            ranks.setdefault(pool[16 * i:16 * i + k], len(ranks))
            if len(ranks) == n_ranks:
                break
    return ranks
