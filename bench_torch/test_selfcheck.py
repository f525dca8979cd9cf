"""CPU self-check of the benchmark: the traffic, the counts, the plain
references, and the output check against the control and the planted
faults, at sizes a test run holds. It measures nothing: no number here is
a device metric.

    python3 -m pytest bench_torch -q
"""

import math
import subprocess
import sys
import time
import types
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_torch import faults, harness  # noqa: E402
from bench_torch.families import hsmm, walks  # noqa: E402
from bench_torch.reference import hsmm as href  # noqa: E402
from bench_torch.reference.tf32 import exact_matmul, round_tf32  # noqa: E402

SEED = 2**31 + 11
SMALL = {"batch": 4, "min_frames": 30, "max_frames": 120, "pool": 3, "warm_calls": 3,
         "check_calls": 4, "trace_calls": 2}
CELLS = [w["name"] for w in harness.json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def small_cell(name, **traffic):
    cell = harness.load_cell(name)
    cell.traffic = dict(cell.traffic, **SMALL, **traffic)
    return cell


def run_small(cell, plant=None, seed=SEED):
    session = harness.make_session(cell.cfg, cell.traffic, seed, "cpu")
    if plant:
        plant(session)
    session.warm()
    harness.run_window(session, 0.2)
    session.free()
    return harness.judged(session.judge(), cell.limits)


# -- traffic -----------------------------------------------------------------------


def _config(name):
    return harness.json.loads((ROOT / "bench_torch" / "configs" / f"{name}.json").read_text())


def test_pool_is_the_seeds():
    fam, cfg = hsmm, _config("hsmm_s10_dmax20_f80")
    traffic = dict(SMALL, max_frames=60)

    def pool(seed):
        gen = torch.Generator().manual_seed(seed)
        w = fam.weights(cfg, gen, torch.device("cpu"))
        return w, harness.Pool(fam, cfg, traffic, w, gen, torch.device("cpu"))

    (w1, a), (w2, b), (_, c) = pool(SEED), pool(SEED), pool(SEED + 1)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert torch.equal(a.obs, b.obs) and torch.equal(a.lengths, b.lengths)
    assert not torch.equal(a.obs, c.obs)
    # The same work on every seed: one full row a batch, the rest an even grid.
    assert sorted(sum(a.lens, [])) == sorted(sum(c.lens, []))
    assert all(r[0] == traffic["max_frames"] for r in a.lens)
    assert min(sum(a.lens, [])) >= traffic["min_frames"]
    # Padding is zero, valid frames are not.
    valid = torch.arange(60)[None, None] < a.lengths[..., None]
    assert torch.all(a.obs[~valid] == 0) and torch.all(a.obs[valid].abs().sum(-1) > 0)


def test_segment_walk_keeps_its_durations():
    gen = torch.Generator().manual_seed(3)
    lens = torch.full((2, 3), 200, dtype=torch.int32)
    states = walks.segments(lens, 10, 200, 20, gen, torch.device("cpu"))
    for row in states.reshape(-1, 200):
        first = torch.cat([torch.tensor([0]), torch.nonzero(row[1:] != row[:-1])[:, 0] + 1])
        durs = torch.diff(torch.cat([first, torch.tensor([200])]))
        assert durs[:-1].min() >= 2 and durs.max() <= 20


# -- counts -----------------------------------------------------------------------


def _kernel(name):
    return harness._load_file(ROOT / "bench_torch" / "rooflines" / f"{name}.py", f"k_{name}")


def test_roofline_counts_by_hand():
    s = {"B": 2, "frames": 10, "D": 3, "N": 4, "K": 2, "Dmax": 5}
    # x 10x3, Wq and Wl 3x4, b 4 in; 10x4 out: 4 (30 + 24 + 4 + 40) bytes.
    # x² 30, two products 4·10·3·4 = 480, bias 40.
    assert _kernel("diag_quadratic").work(s) == (392, 550)
    # log-obs 20, log_a 4, log_pi 2, log_dur 10 in; states 10, score 2 out;
    # per (frame, state) 2·2 + 3·5 = 19.
    assert _kernel("hsmm_smallk_viterbi").work(s) == (192, 380)
    # log-obs 20, log_a 4, log_pi 2, log_dur 10 in; alpha 20, log Z 2 out.
    assert _kernel("hsmm_smallk_forward").work(s) == (232, 20 * (6 + 20))
    # log-obs 20, log_a 4, log_dur 10 in; beta*, beta_start 40 out.
    assert _kernel("hsmm_smallk_backward").work(s) == (296, 20 * (6 + 20))


def test_roofline_reader_by_hand():
    k = _kernel("diag_quadratic")
    shape = {"B": 1, "frames": 1000, "D": 80, "N": 48, "K": 12}
    nbytes, flops = k.work(shape)
    least = max(nbytes / 3.35e12, flops / 67e12)
    r = SimpleNamespace(calls=[shape, shape],
                        ops=[("void diag_quadratic_kernel<6>(float*)", 0.0, 4 * least),
                             ("other_kernel", 0.0, 1.0),
                             ("void diag_quadratic_kernel<6>(float*)", 1.0, 1.0 + 4 * least)])
    assert math.isclose(harness.roofline_pct(k, r), 25.0)
    assert harness.roofline_pct(k, SimpleNamespace(calls=[shape], ops=[("x", 0, 1)])) is None


def test_flops_per_frame_by_hand():
    h = {"num_states": 2, "feature_dim": 4, "max_duration": 5}
    emission = 4 + 2 * 19
    assert hsmm.flops_per_frame(h, "decode") == emission + 2 * (4 + 15)
    assert hsmm.flops_per_frame(h, "train") == emission + 2 * 2 * (6 + 20) + 2 * (20 + 6) + 32


def test_metric_readers_by_hand():
    r = SimpleNamespace(setup_s=3.5, calls=[{}] * 4, stretch_s=2.0, busy_s=0.5,
                        ops=[("a", 0, 1)] * 10,
                        window={"calls": 20, "frames": 1000, "flops": 6.7e12, "seconds": 2.0,
                                "latency_ms": [float(i) for i in range(1, 21)]})
    read = {n: harness.metric_reader(n) for n in
            ("frames_per_s", "latency_p95_ms", "setup_s", "step_mfu_pct",
             "device_ops_per_call", "device_idle_pct")}
    assert read["frames_per_s"](r) == 500.0
    assert read["latency_p95_ms"](r) == 19.0
    assert read["setup_s"](r) == 3.5
    assert math.isclose(read["step_mfu_pct"](r), 5.0)
    assert read["device_ops_per_call"](r) == 2.5
    assert read["device_idle_pct"](r) == 75.0
    # A suffix names the same quantity in other cells, read alike.
    assert harness.metric_reader("device_idle_pct.decode")(r) == 75.0
    k = _kernel("diag_quadratic")
    r.calls = [{"B": 1, "frames": 1000, "D": 80, "N": 48, "K": 12}]
    r.ops = [("diag_quadratic_kernel", 0.0, 1.0)]
    assert harness.metric_reader("diag_quadratic_roofline.train")(r) == harness.roofline_pct(k, r)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10), 3.0e38])
    want = torch.tensor([1.0, 1.0, 1.0 + 4 * 2**-11, -(1.0 + 2**-10), 3.0e38])
    got = round_tf32(x)
    assert torch.equal(got[:4], want[:4]) and math.isclose(got[4], 3.0e38, rel_tol=1e-3)


# -- the references against the port's plain CPU path ---------------------------------


def _problem(fam, name, seed=5):
    cell = small_cell(name)
    session = harness.make_session(cell.cfg, cell.traffic, seed, "cpu")
    return session, *session.pool.batch(0)


def test_hsmm_reference_matches_port():
    s, obs, lengths = _problem(hsmm, "hsmm.decode.b32")
    w, cfg = s.w, s.cfg
    model = s.model
    problem = hsmm.reference_problem(cfg, w, obs, torch.float64, exact_matmul)
    torch.testing.assert_close(model.get_observation_log_probs(obs).double(), problem[0],
                               rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(model.get_duration_log_probs().double(), problem[3],
                               rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(model.log_likelihood(obs, lengths).double(),
                               href.log_z(*problem, lengths), rtol=1e-5, atol=0)
    best, path = href.viterbi(*problem, lengths)
    states, score = model(obs, lengths)
    torch.testing.assert_close(score.double(), best, rtol=1e-5, atol=0)
    torch.testing.assert_close(href.path_score(*problem, states, lengths), best,
                               rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(href.path_score(*problem, path, lengths), best,
                               rtol=1e-12, atol=1e-9)
    # The reference's gradients against the port's (float64 on both sides).
    m64 = model.double()
    m64.zero_grad()
    m64.compute_loss(obs.double(), lengths).backward()
    trainer = href.Trainer(w, 1e-3, cfg["max_duration"], torch.float64, "cpu")
    loss = trainer.loss(obs, lengths)
    grads = torch.autograd.grad(loss, list(trainer.leaves().values()))
    for (name, p), g in zip(trainer.leaves().items(), grads):
        torch.testing.assert_close(dict(m64.named_parameters())[name].grad, g,
                                   rtol=1e-6, atol=1e-8)


# -- the output check ----------------------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused(name):
    cell = small_cell(name)
    ok, checks = run_small(cell, plant=harness.entry(cell.traffic).control)
    assert not ok, checks


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in faults.FAULTS[harness.load_cell(c).traffic["entry"]]])
def test_fault_is_refused(name, fault):
    cell = small_cell(name)
    ok, checks = run_small(cell, plant=lambda s: faults.plant(s, fault))
    assert not ok, checks


def test_kept_calls_keep_their_buffers():
    """A decode call copies into the current host buffers; a kept call
    holds them, and the calls go on in a spare or an evicted one's."""
    cell = small_cell("hsmm.decode.b32")
    session = harness.make_session(cell.cfg, cell.traffic, SEED, "cpu")
    k = cell.traffic["check_calls"]
    bufs = [(torch.empty(2), torch.empty(1)) for _ in range(k + 1)]
    session.out, session.spare = bufs[0], bufs[1:]
    for n in range(60):
        session.keep(n, n, session.out)
        kept = {id(r[0]) for _, r in session.kept}
        assert len(kept) == min(n + 1, k) and id(session.out[0]) not in kept
    assert {id(b[0]) for b in bufs} == kept | {id(session.out[0])}


def _in_float64(session):
    """The port's plain CPU path in float64: a sound run whose numbers
    are rounding alone (the float32 CPU scans, unshifted, read a loss
    3e-6 off at these sizes, over the limits that the card's shifted
    kernels are held to)."""
    model = session.model.double()
    if session.traffic["entry"] == "train":
        loss = session.fam.program_loss
        session.trainer.loss_fn = lambda m, obs, lengths: loss(m, obs.double(), lengths)
    else:
        decode = session.decode
        session.decode = lambda obs, lengths: decode(obs.double(), lengths)
    return model


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_passes(name):
    ok, checks = run_small(small_cell(name), plant=_in_float64)
    assert ok, checks


def test_run_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", CELLS[0],
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def _run_small_cell():
    return harness.run_cell(small_cell("hsmm.decode.b32"), SEED, 0.2, False, "cpu",
                            time.perf_counter())


def _unload_foreign(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FOREIGN:
            monkeypatch.delitem(sys.modules, name)


def test_run_reports_with_the_port_alone(monkeypatch):
    _unload_foreign(monkeypatch)
    import pytorch_hmm_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert harness.foreign_modules() == []
    out = _run_small_cell()
    assert out["attempted"] > 0 and list(out)[-1] == "checks"


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax.linen", "pytorch_hmm_tpu",
                                  "pytorch_hmm_tpu.core"])
@pytest.mark.parametrize("when", ["window", "check"])
def test_run_refuses_jax_in_the_process(monkeypatch, name, when):
    _unload_foreign(monkeypatch)

    def plant():
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))

    if when == "window":
        # Loaded by the time the window closes.
        run_window = harness.run_window
        monkeypatch.setattr(harness, "run_window", lambda *a: (run_window(*a), plant())[0])
    else:
        # Loaded after the window, by the time the run is read.
        judged = harness.judged
        monkeypatch.setattr(harness, "judged", lambda *a: (plant(), judged(*a))[1])
    with pytest.raises(harness.ForeignModules, match=name.split(".")[0]):
        _run_small_cell()
