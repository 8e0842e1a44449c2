"""``native_split_share``: of the UTF-8 bytes of the texts the stream path
split at their allowed specials (``EngineStats.split_bytes``), the share
(%) the native scan split (``EngineStats.split_native``: one
``td_find_specials_l`` call a text under the full allowed set). None where
nothing was split, or the port does not count them."""


def read(run):
    native = run.stats.get("split_native")
    split = run.stats.get("split_bytes")
    if native is None or not split:
        return None
    return 100.0 * native / split
