"""Host time a traced call spends inside the decode span that the call
opened (``models.hsmm.decode`` or ``models.gmm.decode``): the decode's
host path, from the layer's entry to the return of the trellis's launch.
``None`` where the reading has no such span."""

NAMES = ("models.hsmm.decode", "models.gmm.decode")


def read(r):
    spent = [s[2] - s[1] for s in r.spans if s[0] in NAMES]
    if not spent or not r.calls:
        return None
    return 1e3 * sum(spent) / len(r.calls)
