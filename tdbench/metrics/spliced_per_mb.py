"""``spliced_per_mb``: pieces the device missed and the host merged
(``EngineStats.spliced_pieces``) per megabyte (1e6) encoded in the
window."""


def read(run):
    return run.stats["spliced_pieces"] / (run.bytes / 1e6)
