"""``window_ms``: ``EngineStats.device_s`` per window run in the window,
in ms: a window's staging, stage launches and the read of its scalars."""


def read(run):
    if not run.stats["windows"]:  # no window ran: nothing to read
        return None
    return 1e3 * run.stats["device_s"] / run.stats["windows"]
