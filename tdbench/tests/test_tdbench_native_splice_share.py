"""The ``native_splice_share`` reader on canned counters."""

import pytest

from tdbench import run
from tdbench.byname import load


@pytest.mark.parametrize("stats,want", [
    (dict(spliced_pieces=2000, spliced_native=1500), 75.0),
    (dict(spliced_pieces=2000, spliced_native=2000), 100.0),
    (dict(spliced_pieces=2000, spliced_native=0), 0.0),
    (dict(spliced_pieces=0, spliced_native=0), None),   # nothing spliced
    (dict(spliced_pieces=2000), None),      # a port without the counter
])
def test_native_splice_share(stats, want):
    r = run.Run(window_s=1.0, bytes=1, stats=stats)
    got = load("metrics", "native_splice_share").read(r)
    assert got == (None if want is None else pytest.approx(want))
