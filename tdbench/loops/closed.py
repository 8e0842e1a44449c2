"""Loop ``closed``: one caller, in a closed loop over the units in order
and cycled, for ``seconds``; it ends with the first call that ends past
that, and returns the wall from its start to that call's end."""

import time
import traceback


def drive(call, units: list, seconds: float, record) -> float:
    """``record(unit index, latency in s, ids or None, traceback or None)``
    takes every call."""
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        u = i % len(units)
        ts = time.perf_counter()
        try:
            out, err = call(units[u]), None
        except Exception:  # noqa: BLE001 - a failed call is counted
            out, err = None, traceback.format_exc()
        te = time.perf_counter()
        record(u, te - ts, out, err)
        i += 1
        if te >= deadline:
            return te - start
