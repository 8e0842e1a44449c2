"""``kernel_roofline``: the least time the traced slice's work could take
on the card's memory, over the summed time of every kernel in the slice
(%). The least bytes are each input UTF-8 byte read once and one int32
written per id returned, counted from the inputs and outputs (not from the
launched shapes, so a padded window counts only its real bytes), at the
H100 SXM's published 3.35 TB/s."""

from tdbench.trace import HBM_BYTES_PER_S


def read(run):
    sl = run.slice
    if sl is None:
        return None
    kernel_s = sl.kernel_us() * 1e-6
    if kernel_s <= 0:
        return None
    least_s = (sl.bytes + 4 * sl.ids) / HBM_BYTES_PER_S
    return 100.0 * least_s / kernel_s
