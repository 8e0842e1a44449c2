"""``lists_share``: the summed ``td.lists`` spans of the traced slice over
its wall (%): the Python lists the engine builds from each segment's id
array, and the assembly of each text's ids around its specials."""

from tdbench.spans import share


def read(run):
    return share(run.slice, "td.lists")
