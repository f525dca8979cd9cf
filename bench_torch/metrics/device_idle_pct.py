"""Share of the traced stretch's wall time that no device op covers."""


def read(r):
    if not r.ops or not r.stretch_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.stretch_s)
