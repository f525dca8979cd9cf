"""The port's spans (``pytorch_hmm_tpu_torch.trace``): recorded, nested by
layer, under any ``torch.profiler`` run, and never entered without one.

The test marked ``card`` needs a CUDA card and skips elsewhere. On a card,
without the JAX test configuration:

    python3 -m pytest --noconftest -o addopts= -m card tests/test_torch_trace.py
"""

import contextlib
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_hmm_tpu_torch import HSMMLayer, MixtureGaussianHMMLayer, ops, trace

ROOT = Path(__file__).resolve().parent.parent

DECODE = {"models.hsmm.decode", "models.hsmm.emissions", "models.hsmm.transitions",
          "models.hsmm.durations", "ops.diag_quadratic", "ops.auto_hsmm_viterbi"}
LOSS = {"models.hsmm.log_likelihood", "models.hsmm.emissions", "models.hsmm.transitions",
        "models.hsmm.durations", "ops.diag_quadratic", "ops.auto_hsmm_log_z"}
BACKWARD = {"core.hsmm_grads_from_tables", "ops.diag_quadratic.backward"}
KERNELS = {"kernels.diag_quadratic", "kernels.hsmm_smallk_viterbi",
           "kernels.hsmm_smallk_forward", "kernels.hsmm_smallk_backward",
           "kernels.hsmm_table_grads"}
# A card step's backward: the cotangents' kernel under the likelihood's
# backward span; the plain table algebra's span opens on the CPU only.
CARD_BACKWARD = {"kernels.hsmm_table_grads", "ops.hsmm_log_z.backward",
                 "ops.diag_quadratic.backward"}
PREFIXES = ("models.", "ops.", "core.", "kernels.")
# A GMM-HMM decode on the CPU: the transitions span opens three times (the
# mixture weights, log_a, log_pi); row 2's kernel span only on the card.
GMM_DECODE = {"models.gmm.decode", "models.gmm.transitions", "ops.auto_gmm_viterbi",
              "ops.gmm_log_probs", "ops.diag_quadratic"}


def _problem(device, B=3, T=40, S=4, F=6, D=5):
    gen = torch.Generator().manual_seed(7)
    layer = HSMMLayer(S, F, max_duration=D, device=device,
                      generator=torch.Generator().manual_seed(1))
    obs = torch.randn((B, T, F), generator=gen).to(device)
    lengths = torch.tensor([T] + [T - 7 * (b + 1) for b in range(B - 1)],
                           dtype=torch.int32, device=device)
    return layer, obs, lengths


def _gmm(device, B=3, T=40, S=4, C=2, F=6):
    gen = torch.Generator().manual_seed(8)
    layer = MixtureGaussianHMMLayer(S, F, num_components=C, device=device,
                                    generator=torch.Generator().manual_seed(2))
    obs = torch.randn((B, T, F), generator=gen).to(device)
    lengths = torch.tensor([T] + [T - 9 * (b + 1) for b in range(B - 1)],
                           dtype=torch.int32, device=device)
    return layer, obs, lengths


def _ancestors(event):
    event = event.cpu_parent
    while event is not None:
        yield event.name
        event = event.cpu_parent


def test_spans_nest_by_layer_under_a_cpu_profile():
    layer, obs, lengths = _problem("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.decode"):
            layer(obs, lengths)
        with torch.profiler.record_function("test.loss"):
            loss = layer.compute_loss(obs, lengths)
        with torch.profiler.record_function("test.backward"):
            loss.backward()
    events = [e for e in prof.events() if e.name.startswith(PREFIXES)]
    under = {}
    for e in events:
        top = next(a for a in _ancestors(e) if a.startswith("test."))
        under.setdefault(top, set()).add(e.name)
    assert under["test.decode"] == DECODE
    assert under["test.loss"] == LOSS
    assert under["test.backward"] == BACKWARD
    for e in events:
        parents = list(_ancestors(e))
        if e.name == "models.hsmm.emissions":
            assert parents[0] in ("models.hsmm.decode", "models.hsmm.log_likelihood")
        if e.name == "ops.diag_quadratic":
            assert parents[0] == "models.hsmm.emissions"
        if e.name in ("ops.auto_hsmm_viterbi", "models.hsmm.durations"):
            assert parents[0] in ("models.hsmm.decode", "models.hsmm.log_likelihood")
    # Two transition spans a call (log_a, log_pi), one of each other span.
    names = [e.name for e in events]
    assert names.count("models.hsmm.transitions") == 4
    assert names.count("models.hsmm.decode") == names.count("core.hsmm_grads_from_tables") == 1


def test_no_profiler_enters_no_record_function(monkeypatch):
    real = torch.profiler.record_function
    entered = []

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    layer, obs, lengths = _problem("cpu")
    layer(obs, lengths)
    layer.compute_loss(obs, lengths).backward()
    assert entered == []
    assert trace.span("a") is trace.span("b")
    # The same calls under a profiler do enter them: the count above reads
    # the function the spans call.
    with profile(activities=[ProfilerActivity.CPU]):
        layer(obs, lengths)
    assert set(entered) == DECODE


def test_gmm_spans_nest_by_layer_under_a_cpu_profile():
    layer, obs, lengths = _gmm("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.decode"):
            layer(obs, lengths=lengths, return_log_probs=True)
    events = [e for e in prof.events() if e.name.startswith(PREFIXES)]
    assert {e.name for e in events} == GMM_DECODE
    parent = {"models.gmm.transitions": "models.gmm.decode",
              "ops.auto_gmm_viterbi": "models.gmm.decode",
              "ops.gmm_log_probs": "ops.auto_gmm_viterbi",
              "ops.diag_quadratic": "ops.gmm_log_probs",
              "models.gmm.decode": "test.decode"}
    for e in events:
        assert next(_ancestors(e)) == parent[e.name], e.name
    names = [e.name for e in events]
    assert names.count("models.gmm.transitions") == 3
    assert all(names.count(n) == 1 for n in GMM_DECODE - {"models.gmm.transitions"})


def test_gmm_decode_enters_no_record_function_without_a_profiler(monkeypatch):
    real = torch.profiler.record_function
    entered = []

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    layer, obs, lengths = _gmm("cpu")
    layer(obs, lengths=lengths, return_log_probs=True)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        layer(obs, lengths=lengths, return_log_probs=True)
    assert set(entered) == GMM_DECODE


@pytest.mark.parametrize("profiled", [False, True])
def test_smallk_kernel_span_opens_in_the_cuda_branch_only_under_a_profiler(monkeypatch, profiled):
    """``kernels.smallk_viterbi`` opens where the wrapper leaves the CPU
    path, before its checks: here on meta tensors, which the checks then
    refuse; never on CPU tensors."""
    real = torch.profiler.record_function
    entered = []

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    meta = [torch.empty(s, device="meta") for s in ((2, 10, 4), (4, 4), (4,))]
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            ops.smallk_viterbi(*meta)
        ops.smallk_viterbi(*(torch.zeros(t.shape) for t in meta))
    assert entered == (["kernels.smallk_viterbi"] if profiled else [])


# A contextual neural HMM on the CPU: its loss step (the likelihood's
# backward span and the kernel's open on the card only), decode and
# posteriors, each on a ragged batch, so each packs its valid frames.
NEURAL_LOSS = {"models.neural.context", "models.neural.loss", "models.neural.log_likelihood",
               "models.neural.pack", "models.neural.emissions", "models.neural.transitions"}
NEURAL_PARENT = {"models.neural.loss": "test.step", "models.neural.log_likelihood":
                 "models.neural.loss", "models.neural.decode": "test.decode",
                 "models.neural.posteriors": "test.posteriors", "models.neural.context": None}


def _neural(device, B=3, T=30):
    from pytorch_hmm_tpu_torch import ContextualNeuralHMM

    gen = torch.Generator().manual_seed(9)
    hmm = ContextualNeuralHMM(4, 6, 10, linguistic_context_dim=5, prosody_dim=3, hidden_dim=8,
                              dropout=0.0, device=device,
                              generator=torch.Generator().manual_seed(3))
    obs = torch.randn((B, T, 6), generator=gen).to(device)
    ph = torch.randint(0, 10, (B, T), generator=gen).to(device)
    pros = torch.randn((B, T, 3), generator=gen).to(device)
    lengths = torch.tensor([T] + [T - 11 * (b + 1) for b in range(B - 1)], dtype=torch.int32,
                           device=device)
    return hmm, obs, ph, pros, lengths


def test_neural_spans_nest_by_layer_under_a_cpu_profile():
    hmm, obs, ph, pros, lengths = _neural("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.step"):
            hmm.compute_loss(obs, hmm.encode_context(ph, pros), lengths=lengths).backward()
        with torch.profiler.record_function("test.decode"):
            hmm.viterbi_decode(obs, hmm.encode_context(ph, pros), lengths=lengths)
        with torch.profiler.record_function("test.posteriors"):
            hmm.forward_with_context(obs, ph, pros, lengths=lengths)
    events = [e for e in prof.events() if e.name.startswith(PREFIXES)]
    under = {}
    for e in events:
        top = next(a for a in _ancestors(e) if a.startswith("test."))
        under.setdefault(top, set()).add(e.name)
    inner = {"models.neural.context", "models.neural.pack", "models.neural.emissions",
             "models.neural.transitions"}
    assert under["test.step"] == NEURAL_LOSS
    assert under["test.decode"] == inner | {"models.neural.decode"}
    assert under["test.posteriors"] == inner | {"models.neural.posteriors"}
    for e in events:
        parent = next(_ancestors(e))
        if e.name in ("models.neural.pack", "models.neural.emissions",
                      "models.neural.transitions"):
            assert parent in ("models.neural.log_likelihood", "models.neural.decode",
                              "models.neural.posteriors"), parent
        else:
            assert parent == NEURAL_PARENT[e.name] or (
                e.name == "models.neural.context" and parent.startswith("test.")), e.name
    names = [e.name for e in events]
    assert all(names.count(n) == 1 for n in NEURAL_PARENT if n != "models.neural.context")
    assert all(names.count(n) == 3 for n in inner)


@pytest.mark.parametrize("profiled", [False, True])
def test_fbsum_kernel_span_opens_in_the_cuda_branch_only_under_a_profiler(monkeypatch, profiled):
    """``kernels.fbsum_smallk`` opens where the wrapper leaves the CPU
    path, before its checks (here on meta tensors, which they refuse);
    ``ops.fb_log_likelihood.backward`` around the likelihood's backward,
    which only the card's route takes; neither without a profiler."""
    real = torch.profiler.record_function
    entered = []

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    meta = [torch.empty(s, device="meta") for s in ((2, 10, 4), (2, 10, 4, 4), (4,))]
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            ops.fbsum_smallk(*meta)
        ops.fbsum_smallk(*(torch.zeros(t.shape) for t in meta))
        lo = torch.randn((2, 10, 4), requires_grad=True)
        la = torch.log_softmax(torch.randn((2, 10, 4, 4)), -1)
        lp = torch.log_softmax(torch.zeros(4), -1)
        ll = ops._FBLogLikelihood.apply(lo, la, lp, torch.tensor([10, 6], dtype=torch.int32),
                                        "smallk")
        ll.sum().backward()
    assert entered == (["kernels.fbsum_smallk", "ops.fb_log_likelihood.backward"] if profiled
                       else [])
    assert torch.all(lo.grad[1, 6:] == 0) and torch.allclose(lo.grad.sum(-1)[0], torch.ones(10))


@pytest.mark.card
def test_card_spans_cover_every_device_op():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from bench_torch.spans import from_profile

    layer, obs, lengths = _problem("cuda", B=32, T=1000, S=10, F=80, D=20)
    layer(obs, lengths)
    layer.compute_loss(obs, lengths).backward()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as decode:
        layer(obs, lengths)
        torch.cuda.synchronize()
    with profile(activities=acts) as step:
        layer.compute_loss(obs, lengths).backward()
        torch.cuda.synchronize()
    d, s = from_profile(decode), from_profile(step)
    names = {x[0] for x in d["spans"]} | {x[0] for x in s["spans"]}
    assert KERNELS <= names
    step_spans = {x[0] for x in s["spans"]}
    assert CARD_BACKWARD <= step_spans and "core.hsmm_grads_from_tables" not in step_spans
    parents = {x[0]: s["spans"][x[4]][0] for x in s["spans"] if x[4] is not None}
    assert parents["kernels.hsmm_table_grads"] == "ops.hsmm_log_z.backward"
    table_ops = [s["ops"][k][0] for k, i in enumerate(s["op_span"])
                 if i is not None and s["spans"][i][0] == "kernels.hsmm_table_grads"]
    assert len(table_ops) == 2 and all("hsmm_table_grads" in name for name in table_ops)
    assert d["ops"] and None not in d["op_span"]
    under = {d["spans"][i][0] for i in d["op_span"]}
    assert {"kernels.diag_quadratic", "kernels.hsmm_smallk_viterbi"} <= under
