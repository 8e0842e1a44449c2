"""``native_splice_share``: of the pieces the device missed and the host
spliced in the window (``EngineStats.spliced_pieces``), the share (%)
spliced by the native route (``EngineStats.spliced_native``: one
``td_splice`` call a window or grid row). None where nothing was spliced,
or the port does not count them."""


def read(run):
    native = run.stats.get("spliced_native")
    spliced = run.stats.get("spliced_pieces")
    if native is None or not spliced:
        return None
    return 100.0 * native / spliced
