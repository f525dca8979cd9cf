"""Valid frames of every call completed in the window, over the window's
seconds (host clock; the window spans ``run_seconds``)."""


def read(r):
    w = r.window
    return w["frames"] / w["seconds"] if w["calls"] else None
