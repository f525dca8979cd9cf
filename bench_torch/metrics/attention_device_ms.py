"""Device time a traced step of the ops that ran for the
``kernels.attention`` span, forward and backward (the backward's through
the forward op that recorded its node): the transition encoder's
attention kernels with the gathers and scatters of each row's frames,
whatever implements them. ``None`` where the reading has no such span."""

from bench_torch.spans import span_device_ms

NAME = "kernels.attention"


def read(r):
    return span_device_ms(r, NAME)
