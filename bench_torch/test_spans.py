"""CPU checks of ``spans.py``, the harness's traced stretch and the
readers of the program's spans, on canned readings worked by hand and on
CPU profiles of the port. No number here is a device metric.

    python3 -m pytest bench_torch -q
"""

import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_torch import harness, spans  # noqa: E402

SPAN_READERS = ("program_idle_pct.decode", "program_idle_pct.train", "model_host_ms",
                "table_algebra_device_ms", "xi_algebra_device_ms", "attention_device_ms",
                "encoder_device_ms")
OLD = ("device_ops_per_call", "device_idle_pct", "diag_quadratic_roofline")
SEED = 2**31 + 11
SMALL = {"batch": 4, "min_frames": 30, "max_frames": 120, "pool": 3, "warm_calls": 3,
         "check_calls": 4, "trace_calls": 2}

# Thread 1 decodes from 0 to 10 s; thread 2 runs the table algebra from 20
# to 30 s.
RAW = [("models.hsmm.decode", 0.0, 10.0, 1), ("models.hsmm.emissions", 1.0, 3.0, 1),
       ("ops.diag_quadratic", 1.5, 2.5, 1), ("kernels.diag_quadratic", 2.0, 2.4, 1),
       ("ops.auto_hsmm_viterbi", 5.0, 9.0, 1), ("kernels.hsmm_table_grads", 20.0, 30.0, 2)]
# Host sites by correlation id: an aten op inside the emissions, the
# kernel span itself (a ctypes launch), an op inside the dispatch, one in
# the table algebra, one outside every span.
LAUNCHED = {101: (1.2, 1), 102: (2.0, 1), 103: (6.0, 1), 104: (25.0, 2), 105: (15.0, 1)}
OPS = [("mul", 1.3, 1.4), ("diag_quadratic_kernel", 2.2, 2.6), ("hsmm_viterbi", 6.0, 9.5),
       ("exp", 25.0, 27.0), ("copy", 15.0, 16.0), ("unlinked", 31.0, 32.0)]
LINKS = [101, 102, 103, 104, 105, 999]


def canned(with_spans=True):
    s = spans.nest(RAW) if with_spans else []
    return SimpleNamespace(calls=[{"B": 1, "frames": 1000, "D": 80, "N": 48, "K": 12}] * 2,
                           ops=OPS, stretch_s=40.0, busy_s=7.0, spans=s,
                           op_span=spans.owners([LAUNCHED.get(k) for k in LINKS], s))


def test_nesting_and_attribution_by_hand():
    s = spans.nest(RAW)
    name = {i: x[0] for i, x in enumerate(s)}
    parent = {x[0]: (None if x[4] is None else name[x[4]]) for x in s}
    assert parent == {"models.hsmm.decode": None,
                      "models.hsmm.emissions": "models.hsmm.decode",
                      "ops.diag_quadratic": "models.hsmm.emissions",
                      "kernels.diag_quadratic": "ops.diag_quadratic",
                      "ops.auto_hsmm_viterbi": "models.hsmm.decode",
                      "kernels.hsmm_table_grads": None}
    got = [None if i is None else name[i] for i in canned().op_span]
    assert got == ["models.hsmm.emissions", "kernels.diag_quadratic", "ops.auto_hsmm_viterbi",
                   "kernels.hsmm_table_grads", None, None]
    # Any thread: the latest-starting span open at the time.
    assert name[spans.innermost(s, None, 2.3)] == "kernels.diag_quadratic"
    assert name[spans.innermost(s, None, 4.0)] == "models.hsmm.decode"
    assert spans.innermost(s, None, 15.0) is None
    assert spans.innermost(s, 1, 25.0) is None


def _grad(events):
    g = spans.Autograd()
    for e in events:
        g.add(*e)
    return g


# A forward on thread 1 under an encoder span (0-10 s) and an emissions
# span (10-20 s); its backward on thread 7, no program span open, but for
# an explicit backward span (40-45 s). Events: (name, start, end, thread,
# sequence_nr).
FORWARD = [("aten::cast", 1.0, 1.5, 1, 5), ("aten::addmm", 2.0, 3.0, 1, 5),
           ("aten::mm", 2.1, 2.9, 1, -1), ("aten::layer_norm", 4.0, 5.0, 1, 6),
           ("aten::mul", 12.0, 13.0, 1, 7), ("aten::add_", 50.0, 51.0, 1, 9)]
BACKWARD = [("autograd::engine::evaluate_function: MulBackward0", 30.0, 33.0, 7, 7),
            ("MulBackward0", 30.5, 32.5, 7, 7),
            ("autograd::engine::evaluate_function: NativeLayerNormBackward0", 34.0, 36.0, 7, 6),
            ("NativeLayerNormBackward0", 34.2, 35.8, 7, 6),
            ("AddmmBackward0", 37.0, 39.0, 7, 5),
            ("_FBLogLikelihoodBackward", 40.0, 46.0, 7, 8),
            ("aten::mul", 31.0, 32.0, 7, -1)]
PROGRAM = [("models.neural.encoder", 0.0, 10.0, 1), ("models.neural.emissions", 10.0, 20.0, 1),
           ("ops.fb_log_likelihood.backward", 40.5, 45.0, 7)]


def test_backward_put_down_through_its_forward_op_by_hand():
    g = _grad(FORWARD + BACKWARD)
    s = spans.nest(PROGRAM)
    # Sites inside the mul's node, the layer norm's, the addmm's (its
    # number shared by a cast before it: the addmm starts last), the
    # explicit backward span, a node-free instant of the autograd thread,
    # and the optimizer's update after the step (a number no node has).
    sites = [(31.5, 7), (35.0, 7), (38.0, 7), (42.0, 7), (47.0, 7), (50.5, 1)]
    assert [g.forward_site(*w) for w in sites] == [(12.0, 1), (4.0, 1), (2.0, 1), None, None,
                                                   None]
    got = [None if i is None else s[i][0] for i in spans.owners(sites, s, g)]
    assert got == ["models.neural.emissions", "models.neural.encoder", "models.neural.encoder",
                   "ops.fb_log_likelihood.backward", None, None]
    # Without the rule only the explicit backward span is found.
    assert [None if i is None else s[i][0] for i in spans.owners(sites, s)] == [
        None, None, None, "ops.fb_log_likelihood.backward", None, None]


def test_new_readers_by_hand():
    r = canned()
    read = {n: harness.metric_reader(n) for n in SPAN_READERS}
    # Spans cover 20 s; ops run 0.1 + 0.4 + 3.5 + 2.0 s of it: 14 of 40 s idle.
    assert math.isclose(read["program_idle_pct.decode"](r), 35.0)
    assert read["program_idle_pct.train"](r) == read["program_idle_pct.decode"](r)
    assert math.isclose(read["model_host_ms"](r), 5000.0)
    # The table algebra's op runs 2 s over two calls.
    assert math.isclose(read["table_algebra_device_ms"](r), 1000.0)
    for n in ("xi_algebra_device_ms", "attention_device_ms", "encoder_device_ms"):
        assert read[n](r) is None


def test_neural_readers_by_hand():
    """A step of two calls: the encoder (0-10 s) around the attention's
    span (2-4 s) around its kernels' (2.5-3.5 s); the γ/ξ algebra's span on
    the autograd thread; a GMM decode span."""
    raw = [("models.neural.transitions", 0.0, 11.0, 1), ("models.neural.encoder", 0.0, 10.0, 1),
           ("ops.attention", 2.0, 4.0, 1), ("kernels.attention", 2.5, 3.5, 1),
           ("ops.fb_log_likelihood.backward", 20.0, 24.0, 7), ("models.gmm.decode", 30.0, 30.3, 1)]
    s = spans.nest(raw)
    # Sites: in the encoder, in the attention's kernels, in ops.attention
    # outside its kernels, in the γ/ξ span, in the transitions outside the
    # encoder, and outside every span.
    sites = [(1.0, 1), (3.0, 1), (2.2, 1), (21.0, 7), (10.5, 1), (15.0, 1)]
    ops = [("gemm", 0.0, 0.2), ("fmha", 3.0, 3.6), ("gather", 3.6, 3.7), ("xi", 21.0, 21.5),
           ("shift", 11.0, 11.1), ("adam", 40.0, 40.4)]
    r = SimpleNamespace(calls=[{}] * 2, ops=ops, stretch_s=50.0, spans=s,
                        op_span=spans.owners(sites, s))
    read = {n: harness.metric_reader(n) for n in SPAN_READERS}
    assert math.isclose(read["attention_device_ms"](r), 1e3 * 0.6 / 2)
    # The encoder's ops less all under ops.attention (its kernels' too).
    assert math.isclose(read["encoder_device_ms"](r), 1e3 * 0.2 / 2)
    assert math.isclose(read["xi_algebra_device_ms"](r), 1e3 * 0.5 / 2)
    assert math.isclose(read["model_host_ms"](r), 1e3 * 0.3 / 2)
    assert read["table_algebra_device_ms"](r) is None
    assert math.isclose(spans.device_s_under(ops, r.op_span, s, "models.neural.transitions"),
                        0.2 + 0.6 + 0.1 + 0.1)


@pytest.mark.parametrize("reading,silent", [
    (canned(with_spans=False), SPAN_READERS),
    (SimpleNamespace(**dict(vars(canned()), ops=[], op_span=[])),
     [n for n in SPAN_READERS if n != "model_host_ms"]),
    (SimpleNamespace(**dict(vars(canned()), calls=[])),
     [n for n in SPAN_READERS if not n.startswith("program_idle_pct")])])
def test_new_readers_without_spans_read_none(reading, silent):
    for n in silent:
        assert harness.metric_reader(n)(reading) is None, n


def test_old_readers_unchanged_by_the_spans():
    for n in OLD:
        read = harness.metric_reader(n)
        assert read(canned()) == read(canned(with_spans=False))
    assert harness.metric_reader("device_idle_pct")(canned()) == 100.0 * (1 - 7.0 / 40.0)


@pytest.mark.parametrize("name", ["setup_imports_s", "setup_model_s", "setup_warm_s"])
def test_setup_part_readers(name):
    r = SimpleNamespace(setup_s=6.0, setup_parts={"imports": 1.0, "model": 2.0, "warm": 3.0})
    assert harness.metric_reader(name)(r) == {"setup_imports_s": 1.0, "setup_model_s": 2.0,
                                              "setup_warm_s": 3.0}[name]


def test_span_table_by_hand():
    r = canned()
    trace = {"spans": r.spans, "ops": OPS, "op_span": r.op_span}
    rows = {x["span"]: x for x in spans.span_table(trace, 2)}
    decode = rows["models.hsmm.decode"]
    # 10 s inside, less the emissions (2 s) and the dispatch (4 s): 4 s self.
    assert decode["entries"] == 1 and math.isclose(decode["host_ms"], 5000.0)
    assert math.isclose(decode["self_ms"], 2000.0)
    assert math.isclose(decode["device_ms"], 1e3 * (0.1 + 0.4 + 3.5) / 2)
    assert decode["device_ops"] == 1.5
    assert math.isclose(rows["kernels.diag_quadratic"]["device_ms"], 200.0)
    assert rows["kernels.hsmm_table_grads"]["device_ops"] == 0.5
    assert spans.unattributed(trace, 2) == {"copy": [0.5, 500.0], "unlinked": [0.5, 500.0]}


def test_idle_gaps_put_the_program_span_in_the_label():
    host = [("model", 0.0, 10.0), ("to_host", 10.0, 12.0), ("aten::mul", 7.0, 8.0),
            ("cudaStreamSynchronize", 10.5, 12.0)] + [(n, a, b) for n, a, b, _ in RAW]
    ops = [("a", 0.5, 1.0), ("b", 4.0, 5.0), ("c", 10.0, 10.6), ("d", 11.9, 12.5)]
    trace = {"host": host, "ops": ops, "spans": spans.nest(RAW)}
    # Gaps 1-4 s (middle 2.5: the dispatch span is the innermost host
    # event too), 5-10 s (an aten op in the trellis's dispatch), 10.6-11.9 s.
    want = {"model: ops.diag_quadratic": 3.0, "model: ops.auto_hsmm_viterbi: aten::mul": 5.0,
            "to_host: cudaStreamSynchronize": 1.3}
    gaps = spans.idle_gaps(trace)
    assert list(gaps) == sorted(want, key=lambda k: -want[k])
    assert all(math.isclose(gaps[k], v) for k, v in want.items())
    # The breakdown labels its gaps alike, the top ten of them.
    assert harness.breakdown(trace)["idle_gaps"] == [[k, v] for k, v in gaps.items()]
    many = {"host": [("model", 0.0, 100.0)] + [(f"aten::op{k}", 2 * k + 1, 2 * k + 2)
                                               for k in range(12)],
            "ops": [("x", 2 * k, 2 * k + 1) for k in range(13)], "spans": []}
    assert [k for k, _ in harness.breakdown(many)["idle_gaps"]] == [
        f"model: aten::op{k}" for k in range(10)]
    trace["spans"] = []
    assert "model: aten::mul" in spans.idle_gaps(trace)
    # The op that ended last by the wait's end ended 0.1 s into the wait;
    # the host woke 1.4 s later, the device idle 1.3 s of the 1.5 s wait.
    waits = spans.sync_waits(trace)
    assert waits["waits"] == 1 and waits["ended_before_wait"] == 0
    for k, v in (("last_op_end", 100.0), ("wake", 1400.0), ("idle", 1300.0)):
        assert all(math.isclose(x, v) for x in waits[k])


def test_from_profile_reads_the_ports_spans_on_the_cpu():
    from pytorch_hmm_tpu_torch import HSMMLayer

    layer = HSMMLayer(4, 6, max_duration=5, device="cpu")
    obs = torch.randn(2, 30, 6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        layer(obs, torch.tensor([30, 20], dtype=torch.int32))
    trace = spans.from_profile(prof)
    s = trace["spans"]
    parent = {x[0]: (None if x[4] is None else s[x[4]][0]) for x in s}
    assert parent["models.hsmm.decode"] is None
    assert parent["models.hsmm.emissions"] == "models.hsmm.decode"
    assert parent["ops.diag_quadratic"] == "models.hsmm.emissions"
    assert trace["ops"] == [] and trace["op_span"] == []
    assert len(trace["host"]) > len(s)
    assert spans.from_profile(prof, through_forward=True) == trace


# -- the harness's traced stretch ----------------------------------------------


def _session(name, **traffic):
    cell = harness.load_cell(name)
    cell.traffic = {**cell.traffic, **SMALL, **traffic}
    session = harness.make_session(cell.cfg, cell.traffic, SEED, "cpu")
    session.warm()
    return cell, session


def _old_build(prof):
    """``ops`` and ``host`` as the harness built them before it read the
    program's spans: its own loop over the profile's events."""
    dev, host = [], []
    for e in prof.events():
        iv = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(iv)
        elif not getattr(e, "is_user_annotation", False):
            dev.append(iv)
    dev.sort(key=lambda x: x[1])
    return dev, host


def test_run_trace_returns_the_programs_spans(monkeypatch):
    cell, session = _session("hsmm.decode.b32")
    seen, acts = [], []
    read, profiler = spans.from_profile, torch.profiler.profile

    def spy(prof, **kw):
        seen.append((prof, kw))
        return read(prof, **kw)

    def profile_spy(*args, **kw):
        acts.append(kw["activities"])
        return profiler(*args, **kw)

    monkeypatch.setattr(spans, "from_profile", spy)
    monkeypatch.setattr(torch.profiler, "profile", profile_spy)
    first = session.next_call
    trace = harness.run_trace(session, 3)
    # A CPU session asks for the CPU activity alone.
    assert acts == [[ProfilerActivity.CPU]]
    assert len(seen) == 1 and seen[0][1] == {"through_forward": True}
    ops, host = _old_build(seen[0][0])
    assert trace["ops"] == ops and trace["host"] == host
    assert set(trace) == {"ops", "host", "spans", "op_span", "calls", "stretch_s", "read_s"}
    assert session.next_call == first + 3 and len(trace["calls"]) == 3
    names = [s[0] for s in trace["spans"]]
    assert names.count("models.hsmm.decode") == 3
    assert trace["op_span"] == [] and trace["read_s"] >= 0 and trace["stretch_s"] > 0
    r = harness.reading(cell, {"imports": 1.0, "model": 2.0, "warm": 3.0, "total": 6.0},
                        {"calls": 0}, trace)
    assert r.spans is trace["spans"] and r.op_span is trace["op_span"]
    assert harness.metric_reader("model_host_ms")(r) > 0


def test_backward_aten_ops_go_down_to_the_encoder_on_the_cpu():
    """One training step of the attention configuration, profiled on the
    CPU: the autograd nodes of the encoder's LayerNorms and of the
    attention's softmax run outside every program span, and their aten ops
    go down, through the forward op that recorded each node, to
    ``models.neural.encoder`` (the softmax's to ``ops.attention`` inside
    it); every aten op of every node goes down to some program span."""
    _, session = _session("ctxtfm.train.b512", batch=2, min_frames=12, max_frames=24)
    session.tracing = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        session.call(session.next_call)
    session.tracing = False
    events = [e for e in prof.events()]
    s = spans.from_profile(prof)["spans"]
    grad = _grad((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6, e.thread,
                  e.sequence_nr) for e in events)
    nodes = spans.nest([(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6, e.thread)
                        for e in events if spans.is_node(e.name)])
    index = spans.by_thread(nodes)
    seen = {}
    for e in events:
        a = e.time_range.start / 1e6
        j = spans.innermost(nodes, e.thread, a, index)
        if not e.name.startswith("aten::") or j is None:
            continue
        site = [(a, e.thread)]
        launch, = spans.owners(site, s)
        owner, = spans.owners(site, s, grad)
        assert owner is not None, (e.name, nodes[j][0])
        chain = [s[i][0] for i in spans.chain(s, owner)]
        seen.setdefault(nodes[j][0], []).append((launch, chain))
    for node in ("NativeLayerNormBackward0", "SoftmaxBackward0"):
        assert seen.get(node), sorted(seen)
        assert all(launch is None and "models.neural.encoder" in chain
                   for launch, chain in seen[node]), seen[node]
    assert all(chain[0] == "ops.attention" for _, chain in seen["SoftmaxBackward0"])
    assert all(chain[0] == "models.neural.encoder" for _, chain in seen["NativeLayerNormBackward0"])


# -- rooflines and set-up --------------------------------------------------------


def _old_pct(kernel, r):
    """The roofline as the harness read it before ``call_work``: one
    launch's work times the launches it matched a call."""
    import re

    from bench_torch.peaks import least_seconds

    ops = [(a, b) for name, a, b in r.ops if re.search(kernel.PATTERN, name)]
    least = sum(least_seconds(*kernel.work(s)) for s in r.calls) * len(ops) / len(r.calls)
    return 100.0 * least / sum(b - a for a, b in ops)


@pytest.mark.parametrize("what,op,launches,sizes", [
    ("neural_matmul", "sm80_xmma_gemm_f32f32", 49,
     {"B": 512, "frames": 320_000, "D": 80, "K": 12, "H": 256, "C": 80, "P": 16, "rows": 512_000}),
    ("neural_attention", "fmha_cutlassB_f32_aligned", 6,
     {"frames": 320_000, "sum_sq": 224_299_716, "layers": 3, "heads": 8, "H": 256})])
def test_rooflines_count_a_calls_work_not_its_launches(what, op, launches, sizes):
    kernel = harness._load_file(ROOT / "bench_torch" / "rooflines" / f"{what}.py", f"k_{what}")

    def canned_step(n):
        # Two calls of n matched launches each, 1 ms apart, and an op the
        # pattern leaves out.
        ops = [(f"void {op}_kernel<{k}>", 1e-3 * k, 1e-3 * k + 5e-4) for k in range(2 * n)]
        return SimpleNamespace(calls=[sizes, sizes], ops=ops + [("elementwise", 0.0, 9.0)])

    at, more = canned_step(launches), canned_step(launches + 1)
    got = harness.roofline_pct(kernel, at)
    assert math.isclose(got, _old_pct(kernel, at), rel_tol=1e-9)
    # One launch more a call, each as long: the same work over more time.
    assert math.isclose(harness.roofline_pct(kernel, more), got * launches / (launches + 1),
                        rel_tol=1e-9)
    assert math.isclose(_old_pct(kernel, more), got, rel_tol=1e-9)
    # Over the same time the call's work reads the same, where the old
    # formula moved with the count.
    same = SimpleNamespace(calls=at.calls, ops=[(n, a, a + (b - a) * launches / (launches + 1))
                                                for n, a, b in more.ops])
    assert math.isclose(harness.roofline_pct(kernel, same), got, rel_tol=1e-9)
    assert not math.isclose(_old_pct(kernel, same), got, rel_tol=1e-3)


def test_setup_parts_sum_to_setup_s():
    cell = harness.load_cell("hsmm.decode.b32")
    cell.traffic = dict(cell.traffic, **SMALL)
    t_start = time.perf_counter()
    session, setup = harness.set_up(cell, SEED, "cpu", t_start)
    r = harness.reading(cell, setup, {"calls": 0}, None)
    parts = [harness.metric_reader(f"setup_{k}_s")(r) for k in ("imports", "model", "warm")]
    assert all(p >= 0 for p in parts)
    assert math.isclose(sum(parts), harness.metric_reader("setup_s")(r), rel_tol=0, abs_tol=1e-9)
    assert r.spans == [] and r.op_span == [] and r.ops == []
