"""Device time a traced step of the ops launched inside the
``core.hsmm_grads_from_tables`` span (``op_span``): the training
backward's table algebra, apart from Adam, the duration pmf's backward
and the emission's backward, which share its kernels' names. ``None``
where the reading has no such span."""

from bench_torch.spans import device_s_under

NAME = "core.hsmm_grads_from_tables"


def read(r):
    spans = getattr(r, "spans", None)
    if not spans or not r.ops or not r.calls or not any(s[0] == NAME for s in spans):
        return None
    return 1e3 * device_s_under(r.ops, r.op_span, spans, NAME) / len(r.calls)
