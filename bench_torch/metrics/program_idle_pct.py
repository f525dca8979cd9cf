"""Share of the traced stretch in which some program span (``spans``:
``models.*``, ``ops.*``, ``core.*``, ``kernels.*``) is open, on any
thread, and no device op runs: the device waiting on the port's host
path. ``None`` where the reading has no program span."""

from bench_torch.spans import program_idle_s


def read(r):
    spans = getattr(r, "spans", None)
    if not spans or not r.ops or not r.stretch_s:
        return None
    return 100.0 * program_idle_s(r.ops, spans) / r.stretch_s
