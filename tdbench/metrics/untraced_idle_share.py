"""``untraced_idle_share``: of the traced slice's idle device time, the
share (%) whose gaps have their middle under no ``td.*`` span: idle time
the port's spans do not name. The gaps are cut as
``trace.Slice.idle_gaps`` cuts them."""

from tdbench.spans import covered, idle_gaps, spans


def read(run):
    found = spans(run.slice)
    if not found:
        return None
    gaps = idle_gaps(run.slice)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    traced = covered([(a, b) for a, b, _ in found])
    untraced = sum(b - a for a, b in gaps if not traced((a + b) / 2))
    return 100.0 * untraced / idle
