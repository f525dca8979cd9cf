"""Process start to the start of the window: imports, the kernels' load
(a first run in a checkout also builds them), weights, pool, warm-up."""


def read(r):
    return r.setup_s
