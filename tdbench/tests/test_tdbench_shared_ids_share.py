"""The ``shared_ids_share`` reader on canned counters."""

import pytest

from tdbench import run
from tdbench.byname import load


@pytest.mark.parametrize("stats,want", [
    (dict(listed_ids=400_000, listed_shared=300_000), 75.0),
    (dict(listed_ids=400_000, listed_shared=400_000), 100.0),
    (dict(listed_ids=400_000, listed_shared=0), 0.0),
    (dict(listed_ids=0, listed_shared=0), None),   # nothing listed
    (dict(listed_ids=400_000), None),      # a port without the counter
    (dict(spliced_pieces=2000), None),     # a port without either
])
def test_shared_ids_share(stats, want):
    r = run.Run(window_s=1.0, bytes=1, stats=stats)
    got = load("metrics", "shared_ids_share").read(r)
    assert got == (None if want is None else pytest.approx(want))
