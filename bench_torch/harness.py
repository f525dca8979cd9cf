"""One run of one cell: set-up, the measured window, the traced stretch,
the output check and the result line.

A run builds the cell's weights and pool of batches on the device from
the seed, builds the port's model, warms every shape the traffic uses,
and then calls the timed entry in a closed loop for ``seconds``: a call
is due when the one before it returned, and returns when its result is on
the host. With tracing on, a stretch of further calls runs under
``torch.profiler`` after the window closes, in the same steady state, with
the benchmark's own spans around each call's parts; the profile is read
once, the port's own spans with it, and each device op is put down to the
program span it ran for (``spans.py``). Last, the program's state is
freed and its answers are held against the plain reference.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import spans

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# -- the cell ---------------------------------------------------------------------


def load_cell(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell named ``workload`` in ``BENCHMARK.json``, with its
    configuration, traffic mix and limits read from their files, and the
    end-to-end and per-layer metrics that it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    return SimpleNamespace(
        name=workload, chips=cell["chips"],
        cfg=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=e2e, per_layer=layer)


def family(cfg):
    return importlib.import_module(f"bench_torch.families.{cfg['family']}")


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(reading) -> float | None`` of the metric ``name``:
    ``metrics/<name>.py``, or for ``<kernel>_roofline`` the kernel's file
    ``rooflines/<kernel>.py``. A suffix after a dot names the same quantity
    in cells that report another end-to-end metric (``step_mfu_pct.train``
    moves the training cells' metric, ``step_mfu_pct.decode`` the decode
    cells'), and is read by the reader of the name before it."""
    for n in dict.fromkeys((name, name.split(".", 1)[0])):
        path = HERE / "metrics" / f"{n}.py"
        if path.is_file():
            return _load_file(path, f"bench_torch.metrics.{n.replace('.', '_')}").read
        if n.endswith("_roofline"):
            kernel = n[: -len("_roofline")]
            path = HERE / "rooflines" / f"{kernel}.py"
            if path.is_file():
                mod = _load_file(path, f"bench_torch.rooflines.{kernel.replace('.', '_')}")
                return lambda r: roofline_pct(mod, r)
    raise SystemExit(f"no reader for metric {name!r}")


# -- the pool -------------------------------------------------------------------


class Pool:
    """``P`` padded batches made on the device from the seed: features
    ``obs (P, B, T, D)`` and valid ``lengths (P, B)`` (int32). Call ``i``
    takes batch ``i mod P``."""

    def __init__(self, fam, cfg, traffic, w, gen, device):
        from .families import walks

        self.lengths = walks.lengths(traffic, gen, device)
        states = fam.frame_states(cfg, traffic, self.lengths, gen, device)
        obs = fam.observations(w, states, gen)
        self.obs = walks.pad_zero(obs, self.lengths).contiguous()
        self.lens = self.lengths.cpu().tolist()
        self.frames = [sum(r) for r in self.lens]
        self.size = len(self.lens)

    def batch(self, i):
        p = i % self.size
        return self.obs[p], self.lengths[p]


# -- the session ---------------------------------------------------------------


class Session:
    """What every entry shares: the weights, the pool, the port's model,
    the benchmark's spans. An entry (``entries/<entry>.py``) adds
    ``call(i)`` (one timed call on batch ``i mod P``, its result on the
    host), ``warm()``, ``keep(n, i, result)`` (the window's ``n``-th call,
    on batch ``i``) and ``judge()``."""

    def __init__(self, fam, cfg, traffic, seed, device):
        self.fam, self.cfg, self.traffic = fam, cfg, traffic
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.w = fam.weights(cfg, gen, self.device)
        self.pool = Pool(fam, cfg, traffic, self.w, gen, self.device)
        self.model = fam.program(cfg, self.w, self.device)
        self.rng = random.Random(seed)
        self.tracing = False
        self.next_call = 0

    def span(self, name):
        if self.tracing:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def free(self):
        """Drop the program's state before the reference runs."""
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def flops(self, i):
        return self.fam.flops_per_frame(self.cfg, self.traffic["entry"]) * self.pool.frames[
            i % self.pool.size]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _CallClock:
    """Time of one call, from when it was due to when its result was on
    the host: CUDA events on the card (the host clock is too coarse for a
    call of a millisecond), the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop_ms(self):
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


def run_window(session, seconds: float) -> dict:
    """Calls in a closed loop for ``seconds``; a reservoir sample of the
    calls, drawn from the seed, is kept for the check."""
    clock = _CallClock(session.device)
    lat, frames, flops, calls = [], 0, 0.0, 0
    sync(session.device)
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    t_end = t0
    i = session.next_call
    while t_end - t0 < seconds:
        clock.start()
        result = session.call(i)
        lat.append(clock.stop_ms())
        t_end = time.perf_counter()
        frames += session.pool.frames[i % session.pool.size]
        flops += session.flops(i)
        session.keep(calls, i, result)
        calls += 1
        i += 1
    session.next_call = i
    return {"calls": calls, "frames": frames, "flops": flops, "seconds": t_end - t0,
            "latency_ms": lat, "cpu_s": time.process_time() - cpu0}


# -- the traced stretch --------------------------------------------------------


def run_trace(session, calls: int) -> dict:
    """``calls`` more calls under ``torch.profiler`` (its CUDA activity on
    a CUDA device only), the spans on; the profile read once by
    ``spans.from_profile`` with the backward put down through its forward
    ops: ``ops``, ``host``, ``spans``, ``op_span``, and ``calls`` (each
    traced call's sizes), ``stretch_s`` (the stretch's wall time),
    ``read_s`` (the reading's)."""
    from torch.profiler import ProfilerActivity, profile

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
    t_read = time.perf_counter()
    out = spans.from_profile(prof, through_forward=True)
    out["read_s"] = time.perf_counter() - t_read
    out["calls"] = [session.fam.shapes(session.cfg, session.pool.lens[i % session.pool.size])
                    for i in range(first, first + calls)]
    out["stretch_s"] = stretch
    return out


def breakdown(trace: dict) -> dict:
    """The device ops that took most time, and the idle gaps between
    device ops summed by what the host was doing at each gap's middle, as
    ``spans.idle_gaps`` labels them: the benchmark's span, then the
    innermost program span, then the innermost host event."""
    by_op = {}
    for name, a, b in trace["ops"]:
        by_op[name] = by_op.get(name, 0.0) + (b - a)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(by_op), "idle_gaps": top(spans.idle_gaps(trace))}


def roofline_pct(kernel, r):
    """A kernel's least time over its traced time, in percent. The least
    time is that of each traced call's sizes: where the kernel's file has
    ``call_work(sizes)``, the work of the whole call, however many
    launches it takes; otherwise ``work(sizes)``, one launch's, times the
    launches a call that match ``kernel.PATTERN``. The traced time is
    that of those ops. ``None`` where none ran."""
    import re

    from .peaks import least_seconds

    ops = [(a, b) for name, a, b in r.ops if re.search(kernel.PATTERN, name)]
    if not ops or not r.calls:
        return None
    spent = sum(b - a for a, b in ops)
    if hasattr(kernel, "call_work"):
        least = sum(least_seconds(*kernel.call_work(s)) for s in r.calls)
    else:
        least = sum(least_seconds(*kernel.work(s)) for s in r.calls) * len(ops) / len(r.calls)
    return 100.0 * least / spent


# -- a run ---------------------------------------------------------------------


def entry(traffic):
    return importlib.import_module(f"bench_torch.entries.{traffic['entry']}")


def make_session(cfg, traffic, seed, device):
    return entry(traffic).Session(family(cfg), cfg, traffic, seed, device)


def judged(values: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit (a NaN never is)."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(not math.isnan(v) and v <= limits[k] for k, v in values.items())
    return ok and set(values) == set(limits), checks


def set_up(cell, seed: int, device, t_start: float):
    """The session of one run, built and warmed, TF32 off; and the set-up
    in its three parts, each in seconds: ``imports`` (process start to
    here: the imports and the card), ``model`` (weights, pool and the
    port's model) and ``warm`` (the warm-up, which builds the kernels in
    a checkout's first run)."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    session = make_session(cell.cfg, cell.traffic, seed, device)
    sync(device)
    t1 = time.perf_counter()
    session.warm()
    sync(device)
    t2 = time.perf_counter()
    print(f"set-up: imports and card {t0 - t_start:.4f} s, weights, pool and model "
          f"{t1 - t0:.4f} s, warm-up {t2 - t1:.4f} s", file=sys.stderr)
    return session, {"imports": t0 - t_start, "model": t1 - t0, "warm": t2 - t1,
                     "total": t2 - t_start}


def reading(cell, setup: dict, window: dict, traced) -> SimpleNamespace:
    """What the metric readers read (``metrics/__init__.py``) of one run:
    its set-up, its window and, where one ran, its traced stretch."""
    r = SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, setup_s=setup["total"],
                        setup_parts={k: setup[k] for k in ("imports", "model", "warm")},
                        window=window, calls=[], ops=[], stretch_s=0.0, busy_s=0.0,
                        spans=[], op_span=[])
    if traced:
        r.calls, r.ops, r.stretch_s = traced["calls"], traced["ops"], traced["stretch_s"]
        r.spans, r.op_span = traced["spans"], traced["op_span"]
        r.busy_s = sum(b - a for a, b in spans.merged(traced["ops"]))
    return r


def read_metrics(wanted, r) -> dict:
    """``{name: {"value", "unit"}}`` of the metrics ``wanted`` whose
    readers find something to read in ``r``."""
    metrics = {}
    for m in wanted:
        v = metric_reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


# Neither JAX nor the JAX package runs in a process that reports, by whole
# top-level name: the port's own name begins with the JAX package's.
FOREIGN = frozenset({"jax", "jaxlib", "flax", "pytorch_hmm_tpu"})


class ForeignModules(RuntimeError):
    """The process holds JAX or the JAX package: the run reports nothing."""


def foreign_modules() -> list:
    """The top-level names of ``FOREIGN`` that ``sys.modules`` holds."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FOREIGN)


def refuse_foreign():
    found = foreign_modules()
    if found:
        raise ForeignModules(f"the process holds {', '.join(found)}; the benchmark "
                             "measures the PyTorch port alone, and reports nothing")


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run; returns the result line's object. Raises ``ForeignModules``
    where JAX or the JAX package is loaded once the window has closed, or
    once the run is read."""
    device = torch.device(device)
    session, setup = set_up(cell, seed, device, t_start)
    window = run_window(session, seconds)
    refuse_foreign()
    lat = window["latency_ms"]
    print(f"setup {setup['total']:.4f} s; window: {window['calls']} calls, {window['frames']} "
          f"frames in {window['seconds']:.4f} s, {window['cpu_s']:.4f} s of CPU; call median "
          f"{statistics.median(lat):.4f} ms, max {max(lat):.4f} ms", file=sys.stderr)
    tenth = max(1, len(lat) // 10)
    print("call median by tenth of the window, ms: " + " ".join(
        f"{statistics.median(lat[k:k + tenth]):.4f}" for k in range(0, len(lat), tenth)),
        file=sys.stderr)
    traced = run_trace(session, cell.traffic["trace_calls"]) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    session.free()
    values = session.judge()
    correct, checks = judged(values, cell.limits)

    r = reading(cell, setup, window, traced)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, r)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if device.type == "cuda":
        from .card import card_line
        dev["card"] = card_line()
    if traced:
        dev["busy_s"] = r.busy_s
        dev["window_s"] = r.stretch_s
        t_gaps = time.perf_counter()
        parts = breakdown(traced)
        print(f"trace: {len(traced['ops'])} device ops, {len(traced['host'])} host events, "
              f"{len(traced['spans'])} program spans; read in {traced['read_s']:.4f} s, "
              f"breakdown in {time.perf_counter() - t_gaps:.4f} s", file=sys.stderr)
    out = {"correct": correct, "attempted": window["calls"], "failed": 0, "metrics": metrics,
           "device": dev}
    if traced:
        out["breakdown"] = parts
    out["checks"] = checks
    refuse_foreign()
    return out
