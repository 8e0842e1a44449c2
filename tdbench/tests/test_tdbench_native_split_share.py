"""The ``native_split_share`` reader on canned counters."""

import pytest

from tdbench import run
from tdbench.byname import load


@pytest.mark.parametrize("stats,want", [
    (dict(split_bytes=16_000_000, split_native=4_000_000), 25.0),
    (dict(split_bytes=16_000_000, split_native=16_000_000), 100.0),
    (dict(split_bytes=16_000_000, split_native=0), 0.0),
    (dict(split_bytes=0, split_native=0), None),   # nothing split
    (dict(split_bytes=16_000_000), None),  # a port without the counter
    (dict(listed_ids=2000), None),         # a port without either
])
def test_native_split_share(stats, want):
    r = run.Run(window_s=1.0, bytes=1, stats=stats)
    got = load("metrics", "native_split_share").read(r)
    assert got == (None if want is None else pytest.approx(want))
