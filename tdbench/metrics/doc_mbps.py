"""``doc_mbps``: UTF-8 megabytes (1e6) of every call of the window over
the window's wall time (host clock): documents or files, one a call."""


def read(run):
    return run.bytes / 1e6 / run.window_s
