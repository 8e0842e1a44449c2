"""``shared_ids_share``: of the ids the stream path returned as lists
(``EngineStats.listed_ids``, specials included), the share (%) taken from
the CPython extension's shared ints (``EngineStats.listed_shared``: one
``tdpy.assemble_lists`` call a call of the engine). None where nothing was
listed, or the port does not count them."""


def read(run):
    shared = run.stats.get("listed_shared")
    listed = run.stats.get("listed_ids")
    if shared is None or not listed:
        return None
    return 100.0 * shared / listed
