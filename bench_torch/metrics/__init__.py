"""Metric readers, one file each, named as the metric: ``read(reading)``
returns the metric's value, or ``None`` where the run has nothing to read.

A reading carries ``setup_s``; ``window`` (``calls``, ``frames`` (valid),
``flops``, ``seconds``, ``latency_ms`` of every call); and, from a traced
run, ``calls`` (each traced call's sizes), ``ops`` (device ops as ``(name,
start_s, end_s)``), ``stretch_s`` (the traced stretch's wall time) and
``busy_s`` (the time some device op ran)."""
