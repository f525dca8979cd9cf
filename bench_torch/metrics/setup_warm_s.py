"""One of the three parts of set-up that sum to ``setup_s``, on the
host clock: the warm-up calls of every shape the traffic uses
(in a checkout's first run, the kernels' build too)."""


def read(r):
    return r.setup_parts["warm"]
