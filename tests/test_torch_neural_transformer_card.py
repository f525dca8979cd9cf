"""The contextual neural HMM with attention transitions on the card: its
ragged training step held to the CPU in float64, every device op of the
step put down to a span of the port (the attention's forward and
backward kernels under ``kernels.attention``), the attention over each
row's own frames in float32 rather than TF32, its counters at the
cell's shape, and the wrapper raising where its fused kernel cannot run,
never building the ``(B, H, T, T)`` logits.

Two sizes: a small one (S=6, D=8, hidden 32 in 8 heads of 4, B=3, T=40, a
row of one frame) and the benchmark cell's widths
(``ContextualNeuralHMM(12, 80, 64, hidden_dim=256,
transition_type="transformer")``: 3 blocks of 8 heads of 32) at B=16,
T=1000, lengths 1000 down to 250. The card runs float32 with TF32 off;
the CPU runs the same weights in float64 through ``core`` and the masked
einsums.

The tests are marked ``card``: they need a CUDA card and skip elsewhere.
This file imports no JAX. On a card:

    python3 -m pytest --noconftest -o addopts= -m card tests/test_torch_neural_transformer_card.py
"""

import re
import statistics
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

SIZES = {
    "small": dict(S=6, D=8, V=10, L=8, P=4, H=32, B=3, T=40),
    "cell": dict(S=12, D=80, V=64, L=64, P=16, H=256, B=16, T=1000),
}
# As tests/test_torch_neural_card.py: the loss to 1e-5 of itself, each
# leaf's gradient to 1e-3 of the larger of its norm and the median leaf's.
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
                              prosody_dim=z["P"], hidden_dim=z["H"], dropout=0.0,
                              transition_type="transformer", device="cpu",
                              generator=torch.Generator().manual_seed(23))
    gen = torch.Generator().manual_seed(24)
    obs = torch.randn((B, T, z["D"]), generator=gen)
    ph = torch.randint(0, z["V"], (B, T), generator=gen)
    pros = torch.randn((B, T, z["P"]), generator=gen)
    lengths = torch.linspace(T, T // 4, B).round().to(torch.int32)
    if size == "small":
        lengths[1] = 1
    return hmm.to(device), [t.to(device) for t in (obs, ph, pros, lengths)]


def _step(hmm, obs, ph, pros, lengths, seed=None):
    loss = hmm.compute_loss(obs, hmm.encode_context(ph, pros), lengths=lengths)
    loss.backward(seed)
    return loss


@pytest.mark.card
@pytest.mark.parametrize("size", list(SIZES))
def test_card_transformer_step_holds_the_cpu_in_float64(size):
    from pytorch_hmm_tpu_torch.ops import attention

    dev = _card()
    hmm, batch = _problem(size, dev)
    calls, masked = attention.attention_calls, attention.attention_masked_keys
    loss = _step(hmm, *batch)
    torch.cuda.synchronize(dev)
    lengths, T = batch[3], SIZES[size]["T"]
    assert attention.attention_calls == calls + 3
    assert attention.attention_masked_keys == masked + 3 * (lengths.numel() * T
                                                            - int(lengths.sum()))
    ref, _ = _problem(size, "cpu")
    ref = ref.double()
    want = _step(ref, *(t.double() if t.is_floating_point() else t for t in
                        (b.cpu() for b in batch)))
    assert abs(loss.item() - want.item()) <= LOSS_RTOL * abs(want.item()), (loss.item(),
                                                                          want.item())
    got = {k: p.grad for k, p in hmm.named_parameters() if p.grad is not None}
    ref_grads = {k: p.grad for k, p in ref.named_parameters() if p.grad is not None}
    assert set(got) == set(ref_grads) and "transition_matrix" not in got
    assert all(bool(torch.isfinite(g).all()) for g in got.values())
    med = statistics.median(float(g.norm()) for g in ref_grads.values())
    gaps = {k: float((got[k].cpu().double() - g).norm()) / max(float(g.norm()), med)
            for k, g in ref_grads.items()}
    assert max(gaps.values()) <= GRAD_RTOL, gaps


@pytest.mark.card
@pytest.mark.parametrize("size", list(SIZES))
def test_card_attention_ops_lie_under_their_spans(size):
    """One step after the optimizer's update: every device op is put down
    to a program span (``tests/test_torch_neural_card.py``
    ``attribute_step``); the attention's kernels, two a block (forward and
    backward, ``bench_torch/rooflines/neural_attention.py``'s pattern and
    launch count), under ``kernels.attention`` with the gathers and
    scatters of each row's frames; the rest of the encoder, the ragged
    rows included, under ``models.neural.encoder``."""
    from test_torch_neural_card import attribute_step

    from bench_torch.rooflines import neural_attention

    dev = _card()
    hmm, batch = _problem(size, dev)
    opt = torch.optim.Adam(hmm.parameters(), lr=1e-3)
    _step(hmm, *batch)
    torch.cuda.synchronize(dev)
    seed = torch.ones((), device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt.step()
        opt.zero_grad(set_to_none=True)
        _step(hmm, *batch, seed=seed)
        torch.cuda.synchronize(dev)
    d, spans, launchers = attribute_step(prof)
    names = [None if s is None else d["spans"][s][0] for s in spans]
    adam = [k for k, h in enumerate(launchers) if h is not None
            and any(a.startswith("Optimizer.step") for a in _ancestry(h))]
    missing = [d["ops"][k][0] for k, n in enumerate(names) if n is None and k not in adam]
    assert not missing, missing
    kernels = [k for k, op in enumerate(d["ops"]) if re.search(neural_attention.PATTERN, op[0])]
    assert len(kernels) == neural_attention.LAUNCHES, [d["ops"][k][0] for k in kernels]
    assert all(names[k] == "kernels.attention" for k in kernels), [names[k] for k in kernels]
    # The forward kernels launch inside the span; the backward's are put
    # down through the forward op that recorded their node.
    assert sum(d["op_span"][k] is not None for k in kernels) == 3
    # The ragged rows are built once a step under the encoder; each call's
    # span then holds no device op outside its kernels' span.
    seen = set(names)
    assert {"models.neural.encoder", "kernels.attention", "models.neural.transitions"} <= seen
    assert "ops.attention" in {s[0] for s in d["spans"]} and "ops.attention" not in seen


def _ancestry(event):
    names = []
    while event is not None:
        names.append(event.name)
        event = event.cpu_parent
    return names


@pytest.mark.card
def test_card_attention_is_float32_not_tf32():
    """The ragged route (the memory-efficient kernels over each row's own
    frames) against the float64 einsums, on every element, the padded
    queries' zeros and the padded frames' zero gradients included: its
    error is well under that of the benchmark control's attention (every
    product's operands rounded to TF32, forward and backward, under the
    same contract), in the output and in the gradients."""
    from bench_torch.reference.neural_hmm_transformer import batched
    from bench_torch.reference.tf32 import tf32_matmul
    from pytorch_hmm_tpu_torch import ops

    bmm = batched(tf32_matmul)

    def control(a, b, c, keys):
        a, b, c = (t.transpose(1, 2) for t in (a, b, c))
        logits = bmm(a, b.transpose(-1, -2)).masked_fill(~keys[:, None, None, :], float("-inf"))
        out = bmm(torch.softmax(logits, dim=-1), c).transpose(1, 2)
        return out.masked_fill(~keys[:, :, None, None], 0.0)

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(25)
    B, T, Hh, d = 4, 1000, 8, 32
    q, k, v = (torch.randn((B, T, Hh, d), generator=gen, device=dev) for _ in range(3))
    q = q / d ** 0.5
    lengths = torch.tensor([1000, 700, 250, 1], device=dev)
    g = torch.randn((B, T, Hh, d), generator=gen, device=dev)
    keys = torch.arange(T, device=dev)[None] < lengths[:, None]

    def grads(fn, *xs):
        xs = [x.detach().requires_grad_(True) for x in xs]
        out = fn(*xs)
        return [out.detach(), *torch.autograd.grad(out, xs, g.to(out.dtype))]

    want = grads(lambda a, b, c: ops.masked_attention_reference(a, b, c, keys),
                 *(t.double() for t in (q, k, v)))
    got = grads(lambda a, b, c: ops.masked_attention(a, b, c, lengths), q, k, v)
    tf32 = grads(lambda a, b, c: control(a, b, c, keys), q, k, v)
    for name, w, x, y in zip(("out", "dq", "dk", "dv"), want, got, tf32):
        assert torch.equal(x[~keys], torch.zeros_like(x[~keys])), name
        err = float((x.double() - w).abs().max())
        err_tf32 = float((y.double() - w).abs().max())
        assert err * 8 < err_tf32, (name, err, err_tf32)


@pytest.mark.card
def test_card_cell_step_moves_the_counters():
    """At the cell's shape (B=512, T=1000, the traffic's lengths on their
    grid over 250-1000, the cell's widths), a training step takes the
    cumulative-length route in each of the three blocks: the counters move
    by 3 calls and 3·(B·T² − Σ L²) pairs. A call without ``lengths`` takes
    the dense route and moves neither."""
    import json

    from bench_torch.families import walks
    from pytorch_hmm_tpu_torch import ContextualNeuralHMM
    from pytorch_hmm_tpu_torch.ops import attention

    dev = _card()
    z = SIZES["cell"]
    traffic = json.loads((ROOT / "bench_torch" / "traffic" / "train.b512.json").read_text())
    B, T = traffic["batch"], traffic["max_frames"]
    gen = torch.Generator(device=dev).manual_seed(27)
    lengths = walks.lengths(traffic, gen, dev)[0]
    hmm = ContextualNeuralHMM(z["S"], z["D"], z["V"], linguistic_context_dim=z["L"],
                              prosody_dim=z["P"], hidden_dim=z["H"], dropout=0.0,
                              transition_type="transformer", device=dev,
                              generator=torch.Generator().manual_seed(23))
    obs = torch.randn((B, T, z["D"]), generator=gen, device=dev)
    ph = torch.randint(0, z["V"], (B, T), generator=gen, device=dev)
    pros = torch.randn((B, T, z["P"]), generator=gen, device=dev)
    before = attention.attention_varlen_calls, attention.attention_pairs_skipped
    _step(hmm, obs, ph, pros, lengths)
    torch.cuda.synchronize(dev)
    n = lengths.tolist()
    assert min(n) < T
    assert (attention.attention_varlen_calls - before[0],
            attention.attention_pairs_skipped - before[1]) == (3, 3 * (B * T * T - sum(
                x * x for x in n)))
    before = attention.attention_varlen_calls, attention.attention_pairs_skipped
    with torch.no_grad():
        hmm.compute_loss(obs[:8], hmm.encode_context(ph[:8], pros[:8]))
    torch.cuda.synchronize(dev)
    assert (attention.attention_varlen_calls, attention.attention_pairs_skipped) == before


@pytest.mark.card
def test_card_wrapper_raises_rather_than_materialising():
    """Where the memory-efficient kernel cannot run (float64), the wrapper
    raises; where it runs, a forward and backward at B=64, T=1000, 8 heads
    of 32 adds to the card's peak no more than ten tensors of q's size
    (the output, its gradient, q's, k's and v's gradients, the kernel's
    workspace; 655 MB), a third of one ``(B, H, T, T)`` float32 tensor
    (2 GB)."""
    from pytorch_hmm_tpu_torch import ops

    dev = _card()
    x = torch.randn((2, 64, 8, 32), device=dev, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        ops.masked_attention(x, x, x, torch.tensor([64, 10], device=dev))
    gen = torch.Generator(device=dev).manual_seed(26)
    B, T, Hh, d = 64, 1000, 8, 32
    q, k, v = (torch.randn((B, T, Hh, d), generator=gen, device=dev, requires_grad=True)
               for _ in range(3))
    lengths = torch.linspace(T, T // 4, B, device=dev).round().to(torch.int32)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = ops.masked_attention(q, k, v, lengths)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize(dev)
    grown = torch.cuda.max_memory_allocated(dev) - base
    assert grown <= 10 * q.numel() * 4 < B * Hh * T * T * 4 / 3, grown
