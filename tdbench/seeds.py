"""Seeds derived from a run's ``--seed``, one stream a purpose."""

from __future__ import annotations

import numpy as np


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for purpose ``tag`` drawn from ``seed`` (any whole
    number that is not negative)."""
    state = np.random.SeedSequence([int(seed), int(tag)]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))
