"""``card_mbps``: UTF-8 megabytes (1e6) of the traced slice's inputs over
the card's busy time in it, the union of its kernel, copy and memset
intervals: the rate one card encodes at when enough callers keep it fed,
and so the card time a megabyte costs. It is read from the device's own
clock, so the host's speed, which sets ``doc_mbps``, does not enter it."""


def read(run):
    sl = run.slice
    if sl is None or not sl.device:
        return None
    busy_us = sl.busy_us()
    if busy_us <= 0:
        return None
    return sl.bytes / busy_us
