"""Benchmark of the PyTorch and CUDA port (``pytorch_hmm_tpu_torch``).

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``run.py`` reads the cell from ``BENCHMARK.json`` at the checkout's root
and finds everything else by name: the configuration
(``configs/<config>.json``, whose ``family`` names ``families/<family>.py``
and ``reference/<family>.py``), the traffic mix (``traffic/<mix>.json``),
the limits of the output check (``limits/<workload>.json``), each
per-layer metric's reader (``metrics/<metric>.py``, or
``rooflines/<kernel>.py`` for a metric named ``<kernel>_roofline``; a
suffix after a dot, as in ``step_mfu_pct.train``, is read by the reader of
the name before it). A new cell, configuration or metric is new files and
entries.

Nothing here imports JAX or the JAX package; the plain references under
``reference/`` import nothing of the port either.
"""
