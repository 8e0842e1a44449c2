"""``idle_share``: 1 - the union of the kernel, copy and memset intervals
of the traced slice over the slice's wall (%): how far the host holds the
card back."""


def read(run):
    sl = run.slice
    if sl is None or not sl.device or sl.window_us <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_us() / sl.window_us)
