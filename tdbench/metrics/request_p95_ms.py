"""``request_p95_ms``: the 95th percentile of every call's latency in the
window (host clock), in ms."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3
