"""``glue_share``: the share (%) of the window's wall outside the engine's
timed sections (``EngineStats`` ``safe_cut_s``, ``device_s``, ``drain_s``,
``host_s``, ``grid_s``, as deltas over the window): the wrapper's specials
check and split, the building of id lists, and the rest of the glue."""

SECTIONS = ("safe_cut_s", "device_s", "drain_s", "host_s", "grid_s")


def read(run):
    inside = sum(run.stats[k] for k in SECTIONS)
    return 100.0 * (1.0 - inside / run.window_s)
