"""Device operations (kernels, copies, sets) a call, in the traced
stretch."""


def read(r):
    if not r.ops or not r.calls:
        return None
    return len(r.ops) / len(r.calls)
