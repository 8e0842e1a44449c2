"""``starts_roofline``: the least time of the piece starts (K1) over the
summed time of the slice's ``piece_starts*`` kernels (%). The least bytes
are each input UTF-8 byte read once and one start flag bit written per
character, at the H100 SXM's published 3.35 TB/s."""

from tdbench.trace import HBM_BYTES_PER_S

KERNELS = r"\bpiece_starts"


def read(run):
    sl = run.slice
    if sl is None:
        return None
    kernel_s = sl.kernel_us(KERNELS) * 1e-6
    if kernel_s <= 0:
        return None
    least_s = (sl.bytes + sl.chars / 8) / HBM_BYTES_PER_S
    return 100.0 * least_s / kernel_s
