"""``spliced_han_share``: of the pieces the device missed and the host
spliced in the window (``EngineStats.spliced_pieces``), the share (%)
whose first code point is Han (``EngineStats.spliced_han``): under Kimi
K2's pattern the Han runs, which the probe's 16-byte keys cannot hold
from six characters on. None where nothing was spliced, or the port does
not count them."""


def read(run):
    han = run.stats.get("spliced_han")
    spliced = run.stats.get("spliced_pieces")
    if han is None or not spliced:
        return None
    return 100.0 * han / spliced
