"""The readers of the port's ``td.*`` spans and of ``spliced_whole`` on a
canned trace: ``test_tdbench_metrics.EVENTS`` with spans added."""

import pytest

from tdbench import run
from tdbench.spans import covered, idle_gaps
from tdbench.trace import SLICE, read_slice
from test_tdbench_metrics import EVENTS, canned_run, ev, reader

# the slice is [100, 1100], busy [150, 300] + [500, 550] + [1050, 1100];
# its gaps are [100, 150], [300, 500] and [550, 1050]
SPANS = [
    ev("user_annotation", "td.encode", 200, 800),
    ev("user_annotation", "td.specials", 210, 50),
    ev("user_annotation", "td.window", 300, 300),
    ev("user_annotation", "td.grid", 700, 50),
    ev("user_annotation", "td.lists", 900, 50),
    ev("user_annotation", "td.lists", 960, 20),
    ev("user_annotation", "td.lists", 2000, 20),   # after the slice
]


def spanned_run():
    r = canned_run()
    r.slice = read_slice(EVENTS + SPANS)
    r.stats["spliced_whole"] = 500
    return r


def test_idle_gaps_are_those_of_the_slice():
    sl = spanned_run().slice
    gaps = idle_gaps(sl)
    assert gaps == [(100, 150), (300, 500), (550, 1050)]
    assert sum(s for _, s in sl.idle_gaps()) == pytest.approx(
        sum(b - a for a, b in gaps) * 1e-6)


def test_covered_merges_and_bisects():
    at = covered([(5, 7), (0, 2), (1, 3), (10, 10)])
    assert [at(t) for t in (-1, 0, 2.5, 3, 3.5, 6, 10, 11)] == [
        False, True, True, True, False, True, True, False]
    assert not covered([])(0)


@pytest.mark.parametrize("name,want", [
    ("specials_share.doc", 5.0),
    ("specials_share.request", 5.0),
    ("lists_share.doc", 7.0),
    # 4 device events in the slice over one window and one grid
    ("launches_per_window.request", 2.0),
    ("spliced_whole_share.doc", 25.0),
    # [100, 150] has its middle under no span: 50 of 750 µs idle
    ("untraced_idle_share.doc", 100 * 50 / 750),
])
def test_span_readers(name, want):
    assert reader(name)(spanned_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["specials_share.doc", "lists_share.doc",
                                  "launches_per_window.doc",
                                  "untraced_idle_share.request"])
def test_span_readers_without_spans_read_nothing(name):
    assert reader(name)(canned_run()) is None          # a port without them
    r = run.Run(window_s=1.0, bytes=1)
    assert reader(name)(r) is None                     # no trace
    r.slice = read_slice([ev("user_annotation", SLICE, 0, 10)])
    assert reader(name)(r) is None


def test_untraced_idle_share_reads_nothing_without_idle_time():
    r = canned_run()
    r.slice = read_slice([ev("user_annotation", SLICE, 0, 10),
                          ev("kernel", "k", 0, 10),
                          ev("user_annotation", "td.encode", 0, 10)])
    assert reader("untraced_idle_share.doc")(r) is None


def test_spliced_whole_share_reads_nothing_where_nothing_was_counted():
    r = spanned_run()
    r.stats["spliced_pieces"] = 0
    assert reader("spliced_whole_share.doc")(r) is None
    assert reader("spliced_whole_share.doc")(canned_run()) is None
    with pytest.raises(KeyError):
        reader("spliced_whole_share.doc")(run.Run(stats={}))
