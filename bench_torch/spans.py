#!/usr/bin/env python3
"""The port's own spans in a traced stretch, and the device ops and idle
gaps put down to them.

The port names its layers with ``torch.profiler.record_function`` spans
(``pytorch_hmm_tpu_torch.trace``: ``models.*``, ``ops.*``, ``core.*``,
``kernels.*``) while a profiler runs. :func:`from_profile` reads a
finished profile into what ``harness.run_trace`` reads (``ops``, ``host``)
and two more fields:

* ``spans``: each program span as ``(name, start_s, end_s, thread,
  parent)``, ``parent`` the index of the innermost program span of the
  same thread around it, or ``None``;
* ``op_span``: for each entry of ``ops``, the index in ``spans`` of the
  innermost program span open where the op was launched, or ``None``. A
  device op names the host event that launched it: by its
  ``linked_correlation_id`` the aten op (or, for a ``ctypes`` launch, the
  span itself) where ``torch`` gives that field; otherwise, by its own
  correlation id, the CUDA runtime call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...), which lies inside that op or span. The
  innermost program span of that event's thread around its start is the
  one.

The readers ``metrics/program_idle_pct.py``, ``model_host_ms.py`` and
``table_algebra_device_ms.py`` read those two fields from a reading, and
return ``None`` where it has no program span.

    python3 bench_torch/spans.py --workload <name> --seed <n> [--seconds <s>]

runs one cell as ``run.py --trace 1`` does (set-up, a closed-loop window
of ``--seconds``, then the cell's traced stretch) and prints on standard
error the table of program spans (:func:`span_table`), the idle gaps with
the program span at each (:func:`idle_gaps`) and each host wait on the
stream's sync (:func:`sync_waits`); the last line of standard output is a
JSON object with the cell's per-layer metrics read from the same stretch,
the three above among them. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import bisect
import re
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness  # noqa: E402
from bench_torch.card import card_line  # noqa: E402

PREFIXES = ("models.", "ops.", "core.", "kernels.")
SYNC = "cudaStreamSynchronize"
_RUNTIME = re.compile(r"cuda|cu[A-Z]")   # CUDA runtime and driver calls


def from_profile(prof) -> dict:
    """``ops``, ``host``, ``spans`` and ``op_span`` of a finished
    ``torch.profiler.profile``; ``ops`` and ``host`` as
    ``harness.run_trace`` builds them (device ops sorted by start, the
    device side of user annotations left out)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, launched, raw = [], [], {}, []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type != cuda:
            host.append((e.name, a, b))
            if e.name.startswith(PREFIXES):
                raw.append((e.name, a, b, e.thread))
            key = (bool(_RUNTIME.match(e.name)), e.id)
            if not e.is_async and (key not in launched or a < launched[key][0]):
                launched[key] = (a, e.thread)
        elif not getattr(e, "is_user_annotation", False):
            dev.append(((e.name, a, b), launched_by(e)))
    dev.sort(key=lambda x: x[0][1])
    spans = nest(raw)
    return {"ops": [op for op, _ in dev], "host": host, "spans": spans,
            "op_span": attribute([link for _, link in dev], launched, spans)}


def launched_by(event):
    """The key in ``launched`` of the host event that launched a device
    op: ``(False, id)`` of the aten op or span, ``(True, id)`` of the
    runtime call."""
    link = getattr(event, "linked_correlation_id", None)
    return (False, link) if link else (True, event.id)


def nest(raw):
    """Program spans ``(name, start, end, thread)`` with the index of
    each one's parent appended, sorted by start."""
    raw = sorted(raw, key=lambda s: (s[1], -s[2]))
    out, open_ = [], {}
    for name, a, b, thread in raw:
        stack = open_.setdefault(thread, [])
        while stack and out[stack[-1]][2] < a:
            stack.pop()
        out.append((name, a, b, thread, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out


def innermost(spans, thread, t, index=None):
    """Index of the innermost program span of ``thread`` open at ``t``
    (of the latest-starting such span of any thread where ``thread`` is
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


def by_thread(spans):
    """``{thread: (indices, starts)}`` of ``spans`` in start order."""
    index = {}
    for i, s in enumerate(spans):
        ids, starts = index.setdefault(s[3], ([], []))
        ids.append(i)
        starts.append(s[1])
    return index


def attribute(links, launched, spans):
    """``op_span``: for each op's key in ``launched`` (``{key: (start,
    thread)}`` of host events), the innermost program span around the
    launching host event's start."""
    index = by_thread(spans)
    out = []
    for link in links:
        where = launched.get(link)
        out.append(None if where is None else innermost(spans, where[1], where[0], index))
    return out


def chain(spans, i):
    """``i`` and every program span around it, innermost first."""
    while i is not None:
        yield i
        i = spans[i][4]


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
    inside = harness.merged(s[:3] for s in spans)
    busy = harness.merged(ops)
    return sum(b - a for a, b in inside) - overlap(inside, busy)


def device_s_under(ops, op_span, spans, name) -> float:
    """Device time of the ops launched inside a program span ``name``."""
    return sum(b - a for (_, a, b), i in zip(ops, op_span)
               if any(spans[j][0] == name for j in chain(spans, i)))


def span_table(trace, calls: int) -> list:
    """One row for each program span name: its entries over the stretch;
    then a traced call's host ms inside it (inclusive, and less its child
    spans: self), device ms and device ops launched inside it."""
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
        for name in dict.fromkeys(spans[j][0] for j in chain(spans, i)):
            rows[name]["device_ms"] += b - a
            rows[name]["device_ops"] += 1
    for r in rows.values():
        for k in ("host_ms", "self_ms", "device_ms"):
            r[k] = 1e3 * r[k] / calls
        r["device_ops"] /= calls
    return sorted(rows.values(), key=lambda r: -r["host_ms"])


def idle_gaps(trace) -> dict:
    """The idle gaps between device ops summed by label, as
    ``harness.breakdown`` labels them (the benchmark's span, then the
    innermost host event at the gap's middle), with the innermost program
    span at the middle put between the two."""
    host = sorted(trace["host"], key=lambda x: x[1])
    bench = [h for h in host if h[0] in harness._SPANS]
    starts, bench_starts = [h[1] for h in host], [h[1] for h in bench]
    spans = trace["spans"]
    index = by_thread(spans)
    gaps = {}
    busy = harness.merged(trace["ops"])
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        label = [harness._innermost(bench, bench_starts, mid, reach=4) or "between calls"]
        i = innermost(spans, None, mid, index)
        if i is not None:
            label.append(spans[i][0])
        inner = harness._innermost(host, starts, mid)
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
    busy = harness.merged(ops)
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


def traced(session, calls: int):
    """``harness.run_trace``'s stretch of ``calls`` calls (its loop, as
    the harness keeps the profile to itself), read with
    :func:`from_profile`."""
    from torch.profiler import ProfilerActivity, profile

    sync = harness.sync
    session.tracing = True
    sync(session.device)
    first = session.next_call
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if session.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + calls):
            session.call(i)
        sync(session.device)
        stretch = time.perf_counter() - t0
    session.tracing = False
    session.next_call = first + calls
    out = from_profile(prof)
    out["calls"] = [session.fam.shapes(session.cfg, session.pool.lens[i % session.pool.size])
                    for i in range(first, first + calls)]
    out["stretch_s"] = stretch
    return out


def reading(cell, trace):
    """The reading ``harness.run_cell`` makes of a traced stretch, with
    ``spans`` and ``op_span`` on it (no window: none ran to measure)."""
    return SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, setup_s=0.0, window={},
                           calls=trace["calls"], ops=trace["ops"], stretch_s=trace["stretch_s"],
                           busy_s=sum(b - a for a, b in harness.merged(trace["ops"])),
                           spans=trace["spans"], op_span=trace["op_span"])


# The readers of the program's spans, by entry; step_mfu_pct reads the
# window, which this command does not time.
NEW_METRICS = {"decode": ["program_idle_pct.decode", "model_host_ms"],
               "train": ["program_idle_pct.train", "table_algebra_device_ms"]}


def main(argv=None) -> int:
    import argparse
    import json
    import os

    t_start = time.perf_counter()
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
    torch.backends.cuda.matmul.allow_tf32 = False
    session = harness.make_session(cell.cfg, cell.traffic, args.seed, device)
    session.warm()
    harness.sync(device)
    harness.run_window(session, args.seconds)
    trace = traced(session, cell.traffic["trace_calls"])
    r = reading(cell, trace)
    calls = len(trace["calls"])
    names = [m["name"] for m in cell.per_layer if not m["name"].startswith("step_mfu_pct")]
    metrics = {n: harness.metric_reader(n)(r) for n in names + NEW_METRICS[cell.traffic["entry"]]}
    p = sys.stderr
    print(f"{args.workload}: {calls} traced calls, {1e3 * trace['stretch_s'] / calls:.4f} ms a "
          f"call, device busy {1e3 * r.busy_s / calls:.4f} ms a call; card "
          f"{torch.cuda.get_device_name(device)}", file=p)
    print("span                              entries  host ms  self ms  device ms  device ops"
          "   (a traced call)", file=p)
    for row in span_table(trace, calls):
        print(f"{row['span']:<32} {row['entries']:>8} {row['host_ms']:>8.4f} {row['self_ms']:>8.4f}"
              f" {row['device_ms']:>10.4f} {row['device_ops']:>11.2f}", file=p)
    unattributed = sum(1 for i in trace["op_span"] if i is None)
    print(f"device ops with no program span: {unattributed / calls:.2f} a call", file=p)
    gaps = idle_gaps(trace)
    idle = sum(gaps.values())
    named = sum(v for k, v in gaps.items() if not k.startswith("between calls")) / (idle or 1.0)
    print(f"idle gaps, ms a call (of {1e3 * idle / calls:.4f}; {100 * named:.2f}% inside a "
          f"benchmark or program span):", file=p)
    for k, v in list(gaps.items())[:25]:
        print(f"  {1e3 * v / calls:8.4f}  {k}", file=p)
    print(f"sync waits: {sync_waits(trace)}", file=p)
    out = {"workload": args.workload, "seed": args.seed, "calls": calls,
           "traced_ms_per_call": 1e3 * trace["stretch_s"] / calls,
           "card": card_line(),
           "metrics": metrics, "idle_gaps_ms_per_call":
               {k: 1e3 * v / calls for k, v in list(gaps.items())[:25]},
           "idle_named_share": named, "spans": span_table(trace, calls),
           "sync_waits": sync_waits(trace),
           "seconds": time.perf_counter() - t_start}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
