"""Named spans in the port, for whatever ``torch.profiler`` is recording.

    with span("models.hsmm.decode"):
        ...

While a profiler runs, :func:`span` is ``torch.profiler.record_function``:
the span lands in that profiler's trace, on the clock of its device ops,
nested under the spans its thread has open. Otherwise it is one shared
null context, so a span costs one ``torch.autograd._profiler_enabled()``
check where nobody reads it: ``record_function`` enters the dispatcher
even with no profiler running, at many times that cost.

Span names start with their layer: ``models.``, ``ops.``, ``core.``,
``kernels.``.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` in the running profiler's
    trace, and does nothing when no profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
