"""``spliced_whole_share``: of the pieces the device missed and the host
spliced in the window (``EngineStats.spliced_pieces``), the share (%) that
were whole tokens (``EngineStats.spliced_whole``): pieces over the probe's
16-byte keys, and tokens its table dropped. None where nothing was
spliced, or the port does not count them."""


def read(run):
    whole = run.stats.get("spliced_whole")
    spliced = run.stats["spliced_pieces"]
    if whole is None or not spliced:
        return None
    return 100.0 * whole / spliced
