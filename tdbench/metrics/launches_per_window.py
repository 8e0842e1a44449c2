"""``launches_per_window``: the kernel, copy and memset events of the
traced slice over its ``td.window`` and ``td.grid`` spans (each a window's
or a grid's device section): the device work a window costs in launches,
each paid on the host."""

from tdbench.spans import spans


def read(run):
    sections = [n for _, _, n in spans(run.slice)
                if n in ("td.window", "td.grid")]
    if not sections:
        return None
    return len(run.slice.device) / len(sections)
