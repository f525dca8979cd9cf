"""One of the three parts of set-up that sum to ``setup_s``, on the
host clock: process start to the session's build: the imports
and the card (PyTorch's CUDA context, the port's kernel libraries)."""


def read(r):
    return r.setup_parts["imports"]
