"""One of the three parts of set-up that sum to ``setup_s``, on the
host clock: the cell's weights and pool of batches made on the
card from the seed, and the port's model built."""


def read(r):
    return r.setup_parts["model"]
