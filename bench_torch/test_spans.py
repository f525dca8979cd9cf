"""CPU checks of ``spans.py`` and the readers of the program's spans, on
canned readings worked by hand and on a CPU profile of the port. No number
here is a device metric.

    python3 -m pytest bench_torch -q
"""

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_torch import harness, spans  # noqa: E402

NEW = ("program_idle_pct.decode", "program_idle_pct.train", "model_host_ms",
       "table_algebra_device_ms")
OLD = ("device_ops_per_call", "device_idle_pct", "diag_quadratic_roofline")

# Thread 1 decodes from 0 to 10 s; thread 2 runs the table algebra from 20
# to 30 s.
RAW = [("models.hsmm.decode", 0.0, 10.0, 1), ("models.hsmm.emissions", 1.0, 3.0, 1),
       ("ops.diag_quadratic", 1.5, 2.5, 1), ("kernels.diag_quadratic", 2.0, 2.4, 1),
       ("ops.auto_hsmm_viterbi", 5.0, 9.0, 1), ("core.hsmm_grads_from_tables", 20.0, 30.0, 2)]
# Host events by correlation id: an aten op inside the emissions, the
# kernel span itself (a ctypes launch), an op inside the dispatch, one in
# the table algebra, one outside every span.
LAUNCHED = {101: (1.2, 1), 102: (2.0, 1), 103: (6.0, 1), 104: (25.0, 2), 105: (15.0, 1)}
OPS = [("mul", 1.3, 1.4), ("diag_quadratic_kernel", 2.2, 2.6), ("hsmm_viterbi", 6.0, 9.5),
       ("exp", 25.0, 27.0), ("copy", 15.0, 16.0), ("unlinked", 31.0, 32.0)]
LINKS = [101, 102, 103, 104, 105, 999]


def canned(with_spans=True):
    r = SimpleNamespace(calls=[{"B": 1, "frames": 1000, "D": 80, "N": 48, "K": 12}] * 2,
                        ops=OPS, stretch_s=40.0, busy_s=7.0)
    if with_spans:
        r.spans = spans.nest(RAW)
        r.op_span = spans.attribute(LINKS, LAUNCHED, r.spans)
    return r


def test_nesting_and_attribution_by_hand():
    s = spans.nest(RAW)
    name = {i: x[0] for i, x in enumerate(s)}
    parent = {x[0]: (None if x[4] is None else name[x[4]]) for x in s}
    assert parent == {"models.hsmm.decode": None,
                      "models.hsmm.emissions": "models.hsmm.decode",
                      "ops.diag_quadratic": "models.hsmm.emissions",
                      "kernels.diag_quadratic": "ops.diag_quadratic",
                      "ops.auto_hsmm_viterbi": "models.hsmm.decode",
                      "core.hsmm_grads_from_tables": None}
    got = [None if i is None else name[i] for i in spans.attribute(LINKS, LAUNCHED, s)]
    assert got == ["models.hsmm.emissions", "kernels.diag_quadratic", "ops.auto_hsmm_viterbi",
                   "core.hsmm_grads_from_tables", None, None]
    # Any thread: the latest-starting span open at the time.
    assert name[spans.innermost(s, None, 2.3)] == "kernels.diag_quadratic"
    assert name[spans.innermost(s, None, 4.0)] == "models.hsmm.decode"
    assert spans.innermost(s, None, 15.0) is None
    assert spans.innermost(s, 1, 25.0) is None


def test_new_readers_by_hand():
    r = canned()
    read = {n: harness.metric_reader(n) for n in NEW}
    # Spans cover 20 s; ops run 0.1 + 0.4 + 3.5 + 2.0 s of it: 14 of 40 s idle.
    assert math.isclose(read["program_idle_pct.decode"](r), 35.0)
    assert read["program_idle_pct.train"](r) == read["program_idle_pct.decode"](r)
    assert math.isclose(read["model_host_ms"](r), 5000.0)
    assert math.isclose(read["table_algebra_device_ms"](r), 1000.0)


@pytest.mark.parametrize("reading", [canned(with_spans=False),
                                     SimpleNamespace(**dict(vars(canned()), spans=[],
                                                            op_span=[None] * len(OPS)))])
def test_new_readers_without_spans_read_none(reading):
    for n in NEW:
        assert harness.metric_reader(n)(reading) is None


def test_old_readers_unchanged_by_the_spans():
    for n in OLD:
        read = harness.metric_reader(n)
        assert read(canned()) == read(canned(with_spans=False))
    assert harness.metric_reader("device_idle_pct")(canned()) == 100.0 * (1 - 7.0 / 40.0)


def test_span_table_by_hand():
    trace = {"spans": spans.nest(RAW), "ops": OPS,
             "op_span": spans.attribute(LINKS, LAUNCHED, spans.nest(RAW))}
    rows = {r["span"]: r for r in spans.span_table(trace, 2)}
    decode = rows["models.hsmm.decode"]
    # 10 s inside, less the emissions (2 s) and the dispatch (4 s): 4 s self.
    assert decode["entries"] == 1 and math.isclose(decode["host_ms"], 5000.0)
    assert math.isclose(decode["self_ms"], 2000.0)
    assert math.isclose(decode["device_ms"], 1e3 * (0.1 + 0.4 + 3.5) / 2)
    assert decode["device_ops"] == 1.5
    assert math.isclose(rows["kernels.diag_quadratic"]["device_ms"], 200.0)
    assert rows["core.hsmm_grads_from_tables"]["device_ops"] == 0.5


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
    trace["spans"] = []
    plain = {k: v for k, v in harness.breakdown(dict(trace, ops=ops))["idle_gaps"]}
    assert spans.idle_gaps(trace) == plain
    # The op that ended last by the wait's end ended 0.1 s into the wait;
    # the host woke 1.4 s later, the device idle 1.3 s of the 1.5 s wait.
    waits = spans.sync_waits(trace)
    assert waits["waits"] == 1 and waits["ended_before_wait"] == 0
    for k, v in (("last_op_end", 100.0), ("wake", 1400.0), ("idle", 1300.0)):
        assert all(math.isclose(x, v) for x in waits[k])


def test_from_profile_reads_the_ports_spans_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile

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
