#!/usr/bin/env python3
"""The traced stretch read from its profile: the device ops, the host
events, the port's own spans, and each device op put down to the span it
ran for.

The port names its layers with ``torch.profiler.record_function`` spans
(``pytorch_hmm_tpu_torch.trace``: ``models.*``, ``ops.*``, ``core.*``,
``kernels.*``) while a profiler runs. :func:`from_profile` reads a
finished profile, in one pass over its events, into what
``harness.run_trace`` returns:

* ``ops``: the device ops as ``(name, start_s, end_s)``, sorted by start,
  the device side of user annotations left out;
* ``host``: every host event as ``(name, start_s, end_s)``;
* ``spans``: each program span as ``(name, start_s, end_s, thread,
  parent)``, ``parent`` the index of the innermost program span of the
  same thread around it, or ``None``;
* ``op_span``: for each entry of ``ops``, the index in ``spans`` of the
  program span it ran for, or ``None``.

A device op names the host event that launched it: by its
``linked_correlation_id`` the aten op (or, for a ``ctypes`` launch, the
span itself) where ``torch`` gives that field; otherwise, by its own
correlation id, the CUDA runtime call (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...), which lies inside that op or span. The op runs
for the innermost program span of that event's thread around its start.
With ``through_forward``, an op that autograd launched outside every
program span runs for the span that was open where its forward op ran:
the op that recorded the autograd node around the launch, matched by the
node's ``sequence_nr`` (:class:`Autograd`). An op launched inside an
explicit backward span (``ops.hsmm_log_z.backward``) keeps that span.

The readers under ``metrics/`` read ``spans`` and ``op_span`` from a
reading, and return ``None`` where it has no span of theirs.

    python3 bench_torch/spans.py --workload <name> --seed <n> [--seconds <s>]

runs one cell as ``run.py --trace 1`` does (set-up, a closed-loop window
of ``--seconds``, then the cell's traced stretch through
``harness.run_trace``) and prints on standard error the cell's per-layer
metrics as ``BENCHMARK.json`` lists them, the table of program spans
(:func:`span_table`), the device ops with no program span
(:func:`unattributed`), the idle gaps with the program span at each
(:func:`idle_gaps`) and each host wait on the stream's sync
(:func:`sync_waits`); the last line of standard output is a JSON object
with all of these. It checks no output. Needs a CUDA card; exits 2
without one.
"""

from __future__ import annotations

import bisect
import re
import statistics
import sys
import time
from pathlib import Path

import torch

PREFIXES = ("models.", "ops.", "core.", "kernels.")
# The benchmark's own spans around each call's parts (``entries/``).
BENCH_SPANS = ("model", "backward", "optimizer.step", "to_host")
SYNC = "cudaStreamSynchronize"
_RUNTIME = re.compile(r"cuda|cu[A-Z]")   # CUDA runtime and driver calls


def from_profile(prof, through_forward: bool = False) -> dict:
    """``ops``, ``host``, ``spans`` and ``op_span`` of a finished
    ``torch.profiler.profile``, reading ``prof.events()`` once; with
    ``through_forward`` the backward's ops are put down through their
    forward op (:class:`Autograd`)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, launched, raw = [], [], {}, []
    grad = Autograd() if through_forward else None
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type != cuda:
            host.append((e.name, a, b))
            if e.name.startswith(PREFIXES):
                raw.append((e.name, a, b, e.thread))
            key = (bool(_RUNTIME.match(e.name)), e.id)
            if not e.is_async and (key not in launched or a < launched[key][0]):
                launched[key] = (a, e.thread)
            if grad is not None:
                grad.add(e.name, a, b, e.thread, e.sequence_nr)
        elif not getattr(e, "is_user_annotation", False):
            dev.append(((e.name, a, b), launched_by(e)))
    dev.sort(key=lambda x: x[0][1])
    spans = nest(raw)
    sites = [launched.get(link) for _, link in dev]
    return {"ops": [op for op, _ in dev], "host": host, "spans": spans,
            "op_span": owners(sites, spans, grad)}


def launched_by(event):
    """The key in ``launched`` of the host event that launched a device
    op: ``(False, id)`` of the aten op or span, ``(True, id)`` of the
    runtime call."""
    link = getattr(event, "linked_correlation_id", None)
    return (False, link) if link else (True, event.id)


def nest(raw):
    """Intervals ``(name, start, end, thread)`` with the index of each
    one's parent (the innermost of its thread around it) appended, sorted
    by start."""
    raw = sorted(raw, key=lambda s: (s[1], -s[2]))
    out, open_ = [], {}
    for name, a, b, thread in raw:
        stack = open_.setdefault(thread, [])
        while stack and out[stack[-1]][2] < a:
            stack.pop()
        out.append((name, a, b, thread, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out


def by_thread(spans):
    """``{thread: (indices, starts)}`` of ``spans`` in start order."""
    index = {}
    for i, s in enumerate(spans):
        ids, starts = index.setdefault(s[3], ([], []))
        ids.append(i)
        starts.append(s[1])
    return index


def innermost(spans, thread, t, index=None):
    """Index of the innermost span of ``thread`` open at ``t`` (of the
    latest-starting such span of any thread where ``thread`` is
    ``None``), or ``None``. ``index`` is :func:`by_thread` of ``spans``,
    built once for many lookups."""
    index = by_thread(spans) if index is None else index
    if thread is None:
        found = [j for j in (innermost(spans, th, t, index) for th in index) if j is not None]
        return max(found, key=lambda j: spans[j][1], default=None)
    ids, starts = index.get(thread, ([], []))
    k = bisect.bisect_right(starts, t) - 1
    j = ids[k] if k >= 0 else None
    while j is not None and spans[j][2] < t:
        j = spans[j][4]
    return j


def is_node(name: str) -> bool:
    """An autograd node's host event (``AddmmBackward0``,
    ``_FBLogLikelihoodBackward``, and the engine's event around each)."""
    return name.endswith("Backward") or name[:-1].endswith("Backward")


class Autograd:
    """The backward's autograd nodes on the host, and the forward op that
    recorded each. Fed every host event (:meth:`add`), it answers where
    the forward op of a host instant inside a node ran
    (:meth:`forward_site`).

    An op that records a node and the node share a ``sequence_nr``. Ops
    that record none (a cast, an optimizer's update) share the number of
    the next node; the op that records it starts last of them, so the
    latest-starting event of a number outside every node is its forward
    op."""

    def __init__(self):
        self.nodes, self.numbers, self.recorded = [], [], []
        self._tree = None

    def add(self, name, start, end, thread, sequence_nr):
        if is_node(name):
            self.nodes.append((name, start, end, thread))
            self.numbers.append(sequence_nr)
        elif sequence_nr >= 0 and not name.startswith("autograd"):
            self.recorded.append((sequence_nr, start, thread))
        self._tree = None

    def _build(self):
        order = sorted(range(len(self.nodes)),
                       key=lambda i: (self.nodes[i][1], -self.nodes[i][2]))
        self._tree = nest([self.nodes[i] for i in order])
        self._numbers = [self.numbers[i] for i in order]
        self._index = by_thread(self._tree)
        self._forward = {}
        for number, start, thread in self.recorded:
            if innermost(self._tree, thread, start, self._index) is not None:
                continue
            seen = self._forward.get(number)
            if seen is None or start > seen[0]:
                self._forward[number] = (start, thread)

    def forward_site(self, t, thread):
        """``(start, thread)`` of the forward op whose node is the
        innermost one of ``thread`` open at ``t``; ``None`` outside every
        node, or where no forward op of its number was recorded."""
        if self._tree is None:
            self._build()
        j = innermost(self._tree, thread, t, self._index)
        return None if j is None else self._forward.get(self._numbers[j])


def owners(sites, spans, grad=None):
    """For each host site ``(start, thread)`` (or ``None``), the index in
    ``spans`` of the innermost program span around it; where there is
    none and ``grad`` (:class:`Autograd`) has the site inside a node, the
    span around that node's forward op."""
    index = by_thread(spans)
    out = []
    for where in sites:
        i = None if where is None else innermost(spans, where[1], where[0], index)
        if i is None and where is not None and grad is not None:
            fwd = grad.forward_site(where[0], where[1])
            if fwd is not None:
                i = innermost(spans, fwd[1], fwd[0], index)
        out.append(i)
    return out


def chain(spans, i):
    """``i`` and every program span around it, innermost first."""
    while i is not None:
        yield i
        i = spans[i][4]


def merged(intervals):
    """``[[start, end], ...]`` of the union of ``(name, start, end)``
    intervals, sorted."""
    out = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys):
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def program_idle_s(ops, spans) -> float:
    """Time some program span is open, on any thread, while no device op
    runs."""
    inside = merged(s[:3] for s in spans)
    return sum(b - a for a, b in inside) - overlap(inside, merged(ops))


def device_s_under(ops, op_span, spans, name, excluding=None) -> float:
    """Device time of the ops that ran for a program span ``name`` (the
    op's span or one around it), less those that ran for a span
    ``excluding`` inside it."""
    memo = {}

    def counts(i):
        if i not in memo:
            names = [spans[j][0] for j in chain(spans, i)]
            inner = names[:names.index(name)] if name in names else None
            memo[i] = inner is not None and (excluding is None or excluding not in inner)
        return memo[i]

    return sum(b - a for (_, a, b), i in zip(ops, op_span) if i is not None and counts(i))


def span_device_ms(r, name, excluding=None):
    """Device ms a traced call of the ops that ran for the program span
    ``name`` in the reading ``r`` (:func:`device_s_under`); ``None``
    where ``r`` has no such span or no traced call."""
    if not r.ops or not r.calls or not any(s[0] == name for s in r.spans):
        return None
    return 1e3 * device_s_under(r.ops, r.op_span, r.spans, name, excluding) / len(r.calls)


def span_table(trace, calls: int) -> list:
    """One row for each program span name: its entries over the stretch;
    then a traced call's host ms inside it (inclusive, and less its child
    spans: self), device ms and device ops that ran for it or a span
    inside it."""
    spans, ops, op_span = trace["spans"], trace["ops"], trace["op_span"]
    rows = {}
    for s in spans:
        r = rows.setdefault(s[0], {"span": s[0], "entries": 0, "host_ms": 0.0,
                                   "self_ms": 0.0, "device_ms": 0.0, "device_ops": 0})
        r["entries"] += 1
        r["host_ms"] += s[2] - s[1]
        r["self_ms"] += s[2] - s[1]
        if s[4] is not None:
            rows[spans[s[4]][0]]["self_ms"] -= s[2] - s[1]
    for (_, a, b), i in zip(ops, op_span):
        if i is None:
            continue
        for name in dict.fromkeys(spans[j][0] for j in chain(spans, i)):
            rows[name]["device_ms"] += b - a
            rows[name]["device_ops"] += 1
    for r in rows.values():
        for k in ("host_ms", "self_ms", "device_ms"):
            r[k] = 1e3 * r[k] / calls
        r["device_ops"] /= calls
    return sorted(rows.values(), key=lambda r: -r["host_ms"])


def unattributed(trace, calls: int) -> dict:
    """The device ops with no program span, by name: ``[ops a call, ms a
    call]`` each, largest first."""
    out = {}
    for (name, a, b), i in zip(trace["ops"], trace["op_span"]):
        if i is None:
            row = out.setdefault(name, [0.0, 0.0])
            row[0] += 1 / calls
            row[1] += 1e3 * (b - a) / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def latest_open(host, starts, t, reach=256):
    """The name of the latest-starting of ``host`` (sorted by start, with
    ``starts`` its starts) that covers ``t``."""
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(k - reach, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return None


def idle_gaps(trace) -> dict:
    """The idle gaps between device ops summed by what the host was doing
    at each gap's middle, largest first: the benchmark's span (or
    ``between calls``), then the innermost program span of any thread,
    then the innermost host event, each where it differs from the one
    before."""
    host = sorted(trace["host"], key=lambda x: x[1])
    bench = [h for h in host if h[0] in BENCH_SPANS]
    starts, bench_starts = [h[1] for h in host], [h[1] for h in bench]
    spans = trace.get("spans") or []
    index = by_thread(spans)
    gaps = {}
    busy = merged(trace["ops"])
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        label = [latest_open(bench, bench_starts, mid, reach=4) or "between calls"]
        i = innermost(spans, None, mid, index)
        if i is not None:
            label.append(spans[i][0])
        inner = latest_open(host, starts, mid)
        if inner not in (None, *label):
            label.append(inner)
        key = ": ".join(label)
        gaps[key] = gaps.get(key, 0.0) + (b - a)
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def sync_waits(trace) -> dict:
    """Each host wait on ``cudaStreamSynchronize`` against the device ops
    around it, as ``[median, mean, largest]`` over the stretch in ms:
    ``last_op_end`` is where the last op that ended by the wait's end
    ended, from the wait's start (negative: before the wait began, so
    nothing was left to wait for); ``wake`` the wait's end less that op's
    end; ``idle`` the time inside the wait with no device op running."""
    ops = trace["ops"]
    busy = merged(ops)
    ends = sorted(b for _, _, b in ops)
    rows = []
    for name, a, b in trace["host"]:
        if name != SYNC:
            continue
        k = bisect.bisect_right(ends, b) - 1
        if k < 0:
            continue
        rows.append((ends[k] - a, b - ends[k], (b - a) - overlap([[a, b]], busy)))
    if not rows:
        return {}
    cols = list(zip(*rows))
    return {"waits": len(rows),
            **{k: [1e3 * statistics.median(c), 1e3 * statistics.fmean(c), 1e3 * max(c)]
               for k, c in zip(("last_op_end", "wake", "idle"), cols)},
            "ended_before_wait": sum(1 for r in rows if r[0] < 0)}


# -- the command ---------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    import json
    import os

    t_start = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench_torch import harness
    from bench_torch.card import card_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    cell = harness.load_cell(args.workload)
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    session, setup = harness.set_up(cell, args.seed, device, t_start)
    window = harness.run_window(session, args.seconds)
    trace = harness.run_trace(session, cell.traffic["trace_calls"])
    r = harness.reading(cell, setup, window, trace)
    metrics = harness.read_metrics(cell.per_layer, r)
    calls = len(trace["calls"])
    p = sys.stderr
    print(f"{args.workload}: {calls} traced calls, {1e3 * trace['stretch_s'] / calls:.4f} ms a "
          f"call, device busy {1e3 * r.busy_s / calls:.4f} ms a call; the profile read in "
          f"{trace['read_s']:.4f} s; card {card_line()}", file=p)
    for m in cell.per_layer:
        v = metrics.get(m["name"], {}).get("value")
        print(f"  {m['name']:<34} {v!r} {m['unit']}  ({m['layer']})", file=p)
    print("span                              entries  host ms  self ms  device ms  device ops"
          "   (a traced call)", file=p)
    table = span_table(trace, calls)
    for row in table:
        print(f"{row['span']:<32} {row['entries']:>8} {row['host_ms']:>8.4f} {row['self_ms']:>8.4f}"
              f" {row['device_ms']:>10.4f} {row['device_ops']:>11.2f}", file=p)
    loose = unattributed(trace, calls)
    print(f"device ops with no program span, a call: "
          f"{sum(v[0] for v in loose.values()):.2f} ops, {sum(v[1] for v in loose.values()):.4f} ms",
          file=p)
    for k, (n, ms) in list(loose.items())[:25]:
        print(f"  {n:8.2f} ops {ms:10.4f} ms  {k}", file=p)
    gaps = idle_gaps(trace)
    idle = sum(gaps.values())
    named = sum(v for k, v in gaps.items() if not k.startswith("between calls")) / (idle or 1.0)
    print(f"idle gaps, ms a call (of {1e3 * idle / calls:.4f}; {100 * named:.2f}% inside a "
          f"benchmark or program span):", file=p)
    for k, v in list(gaps.items())[:25]:
        print(f"  {1e3 * v / calls:8.4f}  {k}", file=p)
    waits = sync_waits(trace)
    print(f"sync waits: {waits}", file=p)
    out = {"workload": args.workload, "seed": args.seed, "calls": calls,
           "traced_ms_per_call": 1e3 * trace["stretch_s"] / calls,
           "busy_ms_per_call": 1e3 * r.busy_s / calls, "read_s": trace["read_s"],
           "card": card_line(), "metrics": {k: v["value"] for k, v in metrics.items()},
           "idle_gaps_ms_per_call": {k: 1e3 * v / calls for k, v in list(gaps.items())[:25]},
           "idle_named_share": named, "spans": table,
           "unattributed": dict(list(loose.items())[:25]), "sync_waits": waits,
           "seconds": time.perf_counter() - t_start}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
