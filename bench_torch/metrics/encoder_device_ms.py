"""Device time a traced step of the ops that ran for the
``models.neural.encoder`` span, forward and backward, less those of the
attention inside it (``ops.attention``): the transition encoder's input
projection, LayerNorms, projections, feed-forward and residuals. ``None``
where the reading has no such span."""

from bench_torch.spans import span_device_ms

NAME = "models.neural.encoder"


def read(r):
    return span_device_ms(r, NAME, excluding="ops.attention")
