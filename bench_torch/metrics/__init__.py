"""Metric readers, one file each, named as the metric: ``read(reading)``
returns the metric's value, or ``None`` where the run has nothing to read.

A reading (``harness.reading``) carries ``setup_s`` and ``setup_parts``
(``imports``, ``model``, ``warm``: seconds that sum to ``setup_s``);
``window`` (``calls``, ``frames`` (valid), ``flops``, ``seconds``,
``latency_ms`` of every call); and, from a traced run, ``calls`` (each
traced call's sizes), ``ops`` (device ops as ``(name, start_s, end_s)``),
``stretch_s`` (the traced stretch's wall time), ``busy_s`` (the time some
device op ran), ``spans`` (the port's program spans as ``(name, start_s,
end_s, thread, parent)``) and ``op_span`` (for each op, the index in
``spans`` of the span it ran for, the backward's ops through their
forward op, or ``None``): ``spans.from_profile``."""
