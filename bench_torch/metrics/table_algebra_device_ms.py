"""Device time a traced step of the ops that ran for the
``kernels.hsmm_table_grads`` span: the training backward's table algebra
(row 24's launch and its fixed-order reduce), apart from Adam, the
duration pmf's backward and the emission's backward. ``None`` where the
reading has no such span."""

from bench_torch.spans import span_device_ms

NAME = "kernels.hsmm_table_grads"


def read(r):
    return span_device_ms(r, NAME)
