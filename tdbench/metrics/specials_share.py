"""``specials_share``: the summed ``td.specials`` spans of the traced
slice over its wall (%): the wrapper's disallowed-special check and the
engine's split of each text at its specials."""

from tdbench.spans import share


def read(run):
    return share(run.slice, "td.specials")
