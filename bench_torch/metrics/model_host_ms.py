"""Host time a traced call spends inside the ``models.hsmm.decode`` span:
the decode's host path, from the layer's entry to the return of the
segment trellis's launch. ``None`` where the reading has no such span."""

NAME = "models.hsmm.decode"


def read(r):
    spent = [s[2] - s[1] for s in getattr(r, "spans", None) or () if s[0] == NAME]
    if not spent or not r.calls:
        return None
    return 1e3 * sum(spent) / len(r.calls)
