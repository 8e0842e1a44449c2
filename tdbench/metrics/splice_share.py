"""``splice_share``: ``EngineStats.drain_s`` over the window's wall (%):
the copy-back of a window's ids and the host's splice of its misses."""


def read(run):
    return 100.0 * run.stats["drain_s"] / run.window_s
