"""The contextual neural HMM's ragged training step on the card: its loss
and gradients held to the CPU in float64, every device op of the step
put down to a span of the port, and row 3 (``fbsum_smallk``, time-varying
mode) launched once a step.

Two sizes: a small one (S=6, D=8, H=16, B=3, T=40, a row of one frame)
and the benchmark cell's widths (``ContextualNeuralHMM(12, 80, 64,
hidden_dim=256)``, context 64 + 16) at B=64, T=1000, lengths 1000 down to
250. The card runs float32 with TF32 off; the CPU runs the same weights
in float64 through ``core``.

The tests are marked ``card``: they need a CUDA card and skip elsewhere.
This file imports no JAX. On a card:

    python3 -m pytest --noconftest -o addopts= -m card tests/test_torch_neural_card.py
"""

import statistics
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SIZES = {
    "small": dict(S=6, D=8, V=10, L=8, P=4, H=16, B=3, T=40),
    "cell": dict(S=12, D=80, V=64, L=64, P=16, H=256, B=64, T=1000),
}
# float32 on the card against float64: the loss is a mean of log Z over
# rows of up to 1000 frames, each frame's scores rounded at ~1e-7 of
# their size, so 1e-5 of the loss leaves two orders. A gradient sums
# posterior-weighted terms over B·T frames in float32 (its posteriors
# ~1e-5 off at T=1000); each leaf is held to 1e-3 of the larger of its
# norm and the median leaf's, as the benchmark's check reads them.
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(size, device):
    """A seeded model (dropout 0, training mode) and one ragged batch."""
    from pytorch_hmm_tpu_torch import ContextualNeuralHMM

    z = SIZES[size]
    B, T = z["B"], z["T"]
    hmm = ContextualNeuralHMM(z["S"], z["D"], z["V"], linguistic_context_dim=z["L"],
                              prosody_dim=z["P"], hidden_dim=z["H"], dropout=0.0, device="cpu",
                              generator=torch.Generator().manual_seed(20))
    gen = torch.Generator().manual_seed(21)
    obs = torch.randn((B, T, z["D"]), generator=gen)
    ph = torch.randint(0, z["V"], (B, T), generator=gen)
    pros = torch.randn((B, T, z["P"]), generator=gen)
    lengths = torch.linspace(T, T // 4, B).round().to(torch.int32)
    if size == "small":
        lengths[1] = 1
    return hmm.to(device), [t.to(device) for t in (obs, ph, pros, lengths)]


def _step(hmm, obs, ph, pros, lengths, seed=None):
    """The loss and its backward; ``seed`` the loss's gradient, made by the
    caller ahead (autograd fills a one where none is given)."""
    loss = hmm.compute_loss(obs, hmm.encode_context(ph, pros), lengths=lengths)
    loss.backward(seed)
    return loss


@pytest.mark.card
@pytest.mark.parametrize("size", list(SIZES))
def test_card_ragged_step_holds_the_cpu_in_float64(size):
    from pytorch_hmm_tpu_torch import ops

    dev = _card()
    hmm, batch = _problem(size, dev)
    launches = (ops.fbsum_smallk.launches, ops.fbsum_smallk.time_varying_launches)
    loss = _step(hmm, *batch)
    torch.cuda.synchronize(dev)
    assert (ops.fbsum_smallk.launches, ops.fbsum_smallk.time_varying_launches) == (
        launches[0] + 1, launches[1] + 1)
    ref, _ = _problem(size, "cpu")
    ref = ref.double()
    want = _step(ref, *(t.double() if t.is_floating_point() else t for t in
                        (b.cpu() for b in batch)))
    assert abs(loss.item() - want.item()) <= LOSS_RTOL * abs(want.item()), (loss.item(),
                                                                          want.item())
    got = {k: p.grad for k, p in hmm.named_parameters() if p.grad is not None}
    ref_grads = {k: p.grad for k, p in ref.named_parameters() if p.grad is not None}
    assert set(got) == set(ref_grads) and "transition_matrix" not in got
    med = statistics.median(float(g.norm()) for g in ref_grads.values())
    gaps = {k: float((got[k].cpu().double() - g).norm()) / max(float(g.norm()), med)
            for k, g in ref_grads.items()}
    assert max(gaps.values()) <= GRAD_RTOL, gaps


def _is_node(event):
    """An autograd node's event (``AddmmBackward0``,
    ``_FBLogLikelihoodBackward``, and the engine's event around each)."""
    return event.name.endswith("Backward") or event.name[:-1].endswith("Backward")


def _backward_node(event, nodes):
    """The autograd node around a host event: its nearest such ancestor,
    else the latest node of its thread open at its start (a runtime call
    the tree does not nest); None outside the backward."""
    start, thread = event.time_range.start, event.thread
    while event is not None:
        if _is_node(event):
            return event
        event = event.cpu_parent
    open_ = [n for n in nodes.get(thread, ()) if n.time_range.start <= start <= n.time_range.end]
    return max(open_, key=lambda n: n.time_range.start, default=None)


def attribute_step(prof):
    """For each device op of a profiled training step, the index in
    ``spans`` of the program span it runs for: the span open where it was
    launched, or, for an op of the backward that autograd launched
    outside every span, the span open where the forward op that recorded
    its node ran (the node's ``sequence_nr``). ``(trace, spans of the
    ops, the host event that launched each op)``."""
    from bench_torch.spans import _RUNTIME, from_profile, innermost, launched_by

    d = from_profile(prof)
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type != cuda]
    nodes = {}
    for e in events:
        if _is_node(e):
            nodes.setdefault(e.thread, []).append(e)
    host, forward = {}, {}
    for e in events:
        host.setdefault((bool(_RUNTIME.match(e.name)), e.id), e)
        # Ops that record no node (a cast, an optimizer's update) share the
        # number of the next node; the op that records it starts last.
        if (e.sequence_nr >= 0 and not e.name.startswith("autograd")
                and _backward_node(e, nodes) is None):
            seen = forward.get(e.sequence_nr)
            if seen is None or e.time_range.start > seen.time_range.start:
                forward[e.sequence_nr] = e
    dev = sorted((e for e in prof.events() if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    assert [e.name for e in dev] == [op[0] for op in d["ops"]]
    out, launchers = [], []
    for e, span in zip(dev, d["op_span"]):
        launcher = host.get(launched_by(e))
        if span is None and launcher is not None:
            node = _backward_node(launcher, nodes)
            fwd = forward.get(node.sequence_nr) if node is not None else None
            if fwd is not None:
                span = innermost(d["spans"], fwd.thread, fwd.time_range.start / 1e6)
        out.append(span)
        launchers.append(launcher)
    return d, out, launchers


def _ancestry(event):
    names = []
    while event is not None:
        names.append(event.name)
        event = event.cpu_parent
    return names


@pytest.mark.card
@pytest.mark.parametrize("size", list(SIZES))
def test_card_step_ops_lie_under_program_spans(size):
    """One step (the context, the loss, its backward from a seed gradient
    the caller made ahead), after the optimizer's update of the step
    before: every device op of the step is put down to a program span,
    the likelihood's γ/ξ algebra under ``ops.fb_log_likelihood.backward``,
    row 3 under ``kernels.fbsum_smallk``, and the networks' backward
    through the forward ops that recorded it, under ``models.neural.*``."""
    from pytorch_hmm_tpu_torch import ops

    dev = _card()
    hmm, batch = _problem(size, dev)
    opt = torch.optim.Adam(hmm.parameters(), lr=1e-3)
    _step(hmm, *batch)
    torch.cuda.synchronize(dev)
    before = ops.fbsum_smallk.time_varying_launches
    seed = torch.ones((), device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # The update before the step records no node, and shares the
        # number of the step's first one.
        opt.step()
        opt.zero_grad(set_to_none=True)
        _step(hmm, *batch, seed=seed)
        torch.cuda.synchronize(dev)
    assert ops.fbsum_smallk.time_varying_launches == before + 1
    d, spans, launchers = attribute_step(prof)
    adam = [k for k, h in enumerate(launchers)
            if any(a.startswith("Optimizer.step") for a in _ancestry(h))]
    assert adam and all(spans[k] is None for k in adam)
    missing = [(d["ops"][k][0], _ancestry(launchers[k])) for k, s in enumerate(spans)
               if s is None and k not in adam]
    assert d["ops"] and not missing, missing
    step = [k for k in range(len(spans)) if k not in adam]
    names = {k: d["spans"][spans[k]][0] for k in step}
    assert all(n.startswith(("models.neural.", "ops.", "kernels.")) for n in names.values())
    row3 = [d["ops"][k][0] for k, n in names.items() if n == "kernels.fbsum_smallk"]
    assert len(row3) == 1 and "fbsum_kernel" in row3[0]
    assert sum(n == "ops.fb_log_likelihood.backward" for n in names.values()) >= 5
    assert {"models.neural.context", "models.neural.emissions",
            "models.neural.transitions"} <= set(names.values())
    # The networks' backward runs outside every span, put down through its
    # forward ops.
    assert any(d["op_span"][k] is None for k in step)
