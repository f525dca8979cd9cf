"""Device time a traced step of the ops that ran for the
``ops.fb_log_likelihood.backward`` span: the ragged, time-varying
likelihood's backward, the γ/ξ algebra over ``(B, T, S, S)``. ``None``
where the reading has no such span."""

from bench_torch.spans import span_device_ms

NAME = "ops.fb_log_likelihood.backward"


def read(r):
    return span_device_ms(r, NAME)
