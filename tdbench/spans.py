"""The port's ``td.*`` spans in the traced slice.

The port marks its host work with ``record_function`` ranges named
``td.*`` while a trace records (``tokendagger_tpu_torch/utils/profiling
.span``); they reach ``trace.Slice.host`` as ``user_annotation`` events on
the clock of the device events. A port without them leaves the readers
here nothing to read: each returns None.
"""

from __future__ import annotations

import bisect

PREFIX = "td."


def spans(sl) -> list[tuple[float, float, str]]:
    """The slice's ``td.*`` spans, clipped to it: (start, end, name)."""
    if sl is None:
        return []
    return [(a, b, n) for a, b, n in sl.host if n.startswith(PREFIX)]


def share(sl, name: str) -> float | None:
    """The summed ``name`` spans over the slice's wall (%); None without
    ``td.*`` spans."""
    found = spans(sl)
    if not found or sl.window_us <= 0:
        return None
    return 100.0 * sum(b - a for a, b, n in found if n == name) / (
        sl.window_us)


def idle_gaps(sl) -> list[tuple[float, float]]:
    """The slice's idle intervals, as ``trace.Slice.idle_gaps`` cuts
    them: between the device's busy intervals, from the slice's start to
    its end."""
    gaps, t = [], sl.start_us
    for a, b in sorted((a, b) for a, b, _, _ in sl.device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if sl.end_us > t:
        gaps.append((t, sl.end_us))
    return gaps


def covered(intervals: list[tuple[float, float]]):
    """``at(t)``: whether ``t`` lies in one of ``intervals``, by bisection
    over their union."""
    union: list[list[float]] = []
    for a, b in sorted(intervals):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [a for a, _ in union]

    def at(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= union[i][1]
    return at
