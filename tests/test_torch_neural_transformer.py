"""The contextual neural HMM with self-attention transitions
(``NeuralTransitionModel(model_type="transformer")``) on ragged batches:
the attention's keys masked by ``lengths`` (``ops.attention``), held to
the benchmark's plain reference (``bench_torch/reference/
neural_hmm_transformer.py``) and family (``bench_torch/families/
ctxneural_transformer.py``).

The port runs its CPU path here (the masked einsums, ``core``'s scans),
in float64 where it is held to the reference or to itself, so that two
sides differ by rounding alone. Sizes: B=4, T=40, lengths 7 to 40, S=4,
hidden 32, 8 heads of 4, three blocks.
"""

import math
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness  # noqa: E402
from bench_torch.families import ctxneural_transformer as fam  # noqa: E402
from bench_torch.families import neural_hmm as nfam  # noqa: E402
from bench_torch.families import walks  # noqa: E402
from bench_torch.reference import neural_hmm_transformer as ref  # noqa: E402
from pytorch_hmm_tpu_torch import ContextualNeuralHMM, NeuralHMM, ops  # noqa: E402
from pytorch_hmm_tpu_torch.models import neural  # noqa: E402
from pytorch_hmm_tpu_torch.ops import attention  # noqa: E402

S, D, H, V, L, P = 4, 8, 32, 10, 8, 4
CFG = {"num_states": S, "feature_dim": D, "hidden_dim": H, "phoneme_vocab_size": V,
       "linguistic_context_dim": L, "prosody_dim": P, "transition_type": "transformer",
       "num_transformer_layers": 3, "num_heads": 8, "observation_type": "gaussian",
       "dropout": 0.0, "walk_max_dwell": 6, "attention_keys_per_frame": 30.0}
SEED = 2**31 + 23
B, T = 4, 40
LENGTHS = [T, 7, 23, 31]
# As tests/test_torch_neural_reference.py: float64 on both sides over the
# same sums in another order.
LOSS_RTOL, GRAD_RTOL = 1e-10, 1e-8
CUT = dict(rtol=1e-12, atol=1e-10)


def _assert_grads_close(names, got, want):
    """Each leaf's gradient within ``GRAD_RTOL`` of the larger of its norm
    and the median leaf's, as the benchmark's check reads them: the key
    biases' gradients are 0 in exact arithmetic (a bias of the keys adds
    the same logit to every key of a query), and both sides hold
    rounding there."""
    norms = sorted(float(h.norm()) for h in want)
    med = norms[len(norms) // 2]
    for name, g, h in zip(names, got, want):
        assert (g - h).norm() <= GRAD_RTOL * max(float(h.norm()), med), name
        assert h.norm() > 0 or name.endswith("attn.key.bias"), name


def _packed(seed=SEED, lengths=LENGTHS):
    """Seeded weights and one packed batch ``(B, T, D + 1 + P)``, padding
    zero."""
    gen = torch.Generator().manual_seed(seed)
    w = fam.weights(CFG, gen, torch.device("cpu"))
    ln = torch.tensor([lengths], dtype=torch.int32)
    states = fam.frame_states(CFG, {"max_frames": T}, ln, gen, torch.device("cpu"))
    obs = walks.pad_zero(fam.observations(w, states, gen), ln)[0]
    return w, obs, ln[0]


def _model(contextual=True):
    """The port's model in float64, dropout 0: contextual (phonemes and
    prosody) or a NeuralHMM on a given context of 5."""
    kw = dict(hidden_dim=H, transition_type="transformer", dropout=0.0, device="cpu",
              generator=torch.Generator().manual_seed(4))
    if contextual:
        return ContextualNeuralHMM(S, D, V, linguistic_context_dim=L, prosody_dim=P, **kw).double()
    return NeuralHMM(S, D, context_dim=5, **kw).double()


def _inputs(pad=0.0, seed=9):
    """``(features, phonemes, prosody)`` of one batch, the frames past each
    row's length set to ``pad`` (fresh noise where ``pad`` is None)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T, D), generator=gen, dtype=torch.float64)
    ph = torch.randint(0, V, (B, T), generator=gen)
    pros = torch.randn((B, T, P), generator=gen, dtype=torch.float64)
    valid = torch.arange(T)[None] < torch.tensor(LENGTHS)[:, None]
    noise = torch.Generator().manual_seed(seed + 1)

    def padded(t):
        if pad is not None:
            fill = torch.full_like(t, pad)
        elif t.is_floating_point():
            fill = torch.randn(t.shape, generator=noise, dtype=t.dtype)
        else:
            fill = torch.randint(0, V, t.shape, generator=noise)
        keep = valid.reshape(*valid.shape, *([1] * (t.ndim - 2)))
        return torch.where(keep, t, fill)

    return [padded(t) for t in (x, ph, pros)]


def _loss_and_grads(model, inputs, lengths):
    x, ph, pros = inputs
    loss = model.compute_loss(x, model.encode_context(ph, pros), lengths=lengths)
    params = [p for _, p in model.named_parameters()]
    return loss, torch.autograd.grad(loss, params, allow_unused=True)


def _calls(model, inputs, lengths):
    """``(log-likelihood, (states, score), (posteriors, alpha, beta))``."""
    x, ph, pros = inputs
    ctx = model.encode_context(ph, pros)
    return (model.compute_likelihood(x, ctx, lengths=lengths),
            model.viterbi_decode(x, ctx, lengths=lengths),
            model.forward_with_context(x, ph, pros, lengths=lengths))


# -- the port against the plain reference -------------------------------------------


@pytest.mark.parametrize("block_rows", [ref.BLOCK_ROWS, 1])
def test_loss_and_gradients_match_the_reference(monkeypatch, block_rows):
    """The family's program (the port) and the reference in float64: the
    loss and every leaf's gradient, the reference in its blocks of rows
    (each cut to its longest row) or a row at a time."""
    w, obs, lengths = _packed()
    model = fam.program(CFG, w, torch.device("cpu")).double()
    loss = fam.program_loss(model, obs.double(), lengths)
    names = list(ref.leaves(CFG["num_transformer_layers"]))
    params = dict(model.named_parameters())
    assert set(names) == set(params) - {"hmm.transition_matrix"}
    got = torch.autograd.grad(loss, [params[k] for k in names])
    monkeypatch.setattr(ref, "BLOCK_ROWS", block_rows)
    trainer = fam.reference_trainer(CFG, w, 1e-3, torch.float64, "cpu", ref.exact_matmul)
    want_loss, want = trainer.loss_and_grads(obs, lengths)
    assert abs(loss.item() - want_loss.item()) <= LOSS_RTOL * abs(want_loss.item())
    _assert_grads_close(names, got, want)


def test_reference_tf32_products_round_the_attention():
    """The control's batched products round both operands to TF32, forward
    and backward, as ``tf32_matmul`` does a 2-D product."""
    gen = torch.Generator().manual_seed(3)
    a = torch.randn((2, 3, 5, 4), generator=gen, requires_grad=True)
    b = torch.randn((2, 3, 4, 6), generator=gen, requires_grad=True)
    bmm = ref.batched(ref.tf32_matmul)
    out = bmm(a, b)
    for i in range(2):
        for j in range(3):
            assert torch.equal(out[i, j], ref.tf32_matmul(a[i, j], b[i, j]))
    assert not torch.equal(out, a @ b)
    g = torch.randn(out.shape, generator=gen)
    ga, gb = torch.autograd.grad(out, (a, b), g)
    ra, rb, rg = (ref.round_tf32(t.detach()) for t in (a, b, g))
    assert torch.equal(ga, rg @ rb.transpose(-1, -2)) and torch.equal(gb, ra.transpose(-1, -2) @ rg)
    assert ref.batched(ref.exact_matmul) is torch.matmul
    with pytest.raises(ValueError):
        ref.batched(lambda x, y: x @ y)


# -- lengths cut the padding out ---------------------------------------------------


def test_lengths_equal_each_row_cut_to_its_length():
    model = _model()
    inputs = _inputs(pad=None)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    ll, (states, score), post = _calls(model, inputs, lengths)
    for b, n in enumerate(LENGTHS):
        cut = [t[b:b + 1, :n] for t in inputs]
        ll_b, (states_b, score_b), post_b = _calls(model, cut, None)
        torch.testing.assert_close(ll[b:b + 1], ll_b, **CUT)
        torch.testing.assert_close(score[b:b + 1], score_b, **CUT)
        assert torch.equal(states[b:b + 1, :n], states_b)
        for p, q in zip(post, post_b):
            torch.testing.assert_close(p[b:b + 1, :n], q, **CUT)


def test_ragged_step_equals_each_row_run_alone():
    """The loss of a ragged step is the mean of each row's loss run alone on
    its own frames, and each parameter's gradient the mean of theirs."""
    model = _model()
    inputs = _inputs(pad=None)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    loss, grads = _loss_and_grads(model, inputs, lengths)
    rows = [_loss_and_grads(model, [t[b:b + 1, :n] for t in inputs], None)
            for b, n in enumerate(LENGTHS)]
    want = sum(r[0] for r in rows) / B
    assert abs(loss.item() - want.item()) <= LOSS_RTOL * abs(want.item())
    names, got, want = [], [], []
    for k, (name, _) in enumerate(model.named_parameters()):
        if grads[k] is None:
            assert all(r[1][k] is None for r in rows), name
            continue
        names.append(name)
        got.append(grads[k])
        want.append(sum(r[1][k] for r in rows) / B)
    _assert_grads_close(names, got, want)


def test_padding_changes_nothing():
    """Other features and context in the padded frames change no valid
    output and no gradient, and the loss's gradient leaves the padded
    features alone."""
    model = _model()
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    zero, noise = _inputs(0.0), _inputs(None)
    a, b = _calls(model, zero, lengths), _calls(model, noise, lengths)
    torch.testing.assert_close(a[0], b[0], **CUT)
    torch.testing.assert_close(a[1][1], b[1][1], **CUT)
    assert torch.equal(a[1][0], b[1][0])
    valid = torch.arange(T)[None] < lengths[:, None]
    for p, q in zip(a[2], b[2]):
        torch.testing.assert_close(p[valid], q[valid], **CUT)
    (la, ga), (lb, gb) = _loss_and_grads(model, zero, lengths), _loss_and_grads(model, noise,
                                                                               lengths)
    torch.testing.assert_close(la, lb, **CUT)
    for g, h in zip(ga, gb):
        assert (g is None) == (h is None)
        if g is not None:
            torch.testing.assert_close(g, h, **CUT)
    x = noise[0].clone().requires_grad_(True)
    loss = model.compute_loss(x, model.encode_context(noise[1], noise[2]), lengths=lengths)
    (g,) = torch.autograd.grad(loss, [x])
    assert torch.all(g[~valid] == 0) and torch.all(g[valid].abs().sum(-1) > 0)


def _unmasked_logits(tm, ctx):
    """The encoder as the JAX package writes it, with no mask: two einsums
    around a softmax a block."""
    h = tm.in_proj(ctx)
    for blk in tm.blocks:
        a, x = blk.attn, blk.ln1(h)
        n, t, _ = x.shape
        q = a.query(x).view(n, t, a.num_heads, a.head_dim) / math.sqrt(a.head_dim)
        k = a.key(x).view(n, t, a.num_heads, a.head_dim)
        v = a.value(x).view(n, t, a.num_heads, a.head_dim)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        h = h + a.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(n, t, -1))
        h = h + blk.ff2(torch.relu(blk.ff1(blk.ln2(h))))
    uniform = torch.full((*h.shape[:2], tm.num_states), 1.0 / tm.num_states, dtype=h.dtype)
    return tm.output_layer(torch.cat([h, uniform], -1)).reshape(*h.shape[:2], S, S)


@pytest.mark.parametrize("lengths", ["none", "full"])
def test_no_lengths_is_the_unmasked_encoder_bit_for_bit(lengths):
    """Without ``lengths``, or with every row full, the encoder computes
    the unmasked einsums bit for bit (the JAX parity tests hold that path),
    in float32 and its gradients too."""
    tm = neural.NeuralTransitionModel(S, 5, hidden_dim=H, model_type="transformer", dropout=0.0,
                                      device="cpu")
    ctx = torch.randn((B, T, 5), generator=torch.Generator().manual_seed(7))
    ln = None if lengths == "none" else torch.full((B,), T, dtype=torch.int32)
    got = tm.transition_logits(ctx, lengths=ln)
    want = _unmasked_logits(tm, ctx)
    assert torch.equal(got, want)
    params = list(tm.parameters())
    g1 = torch.autograd.grad(got.square().sum(), params)
    g2 = torch.autograd.grad(want.square().sum(), params)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_lengths_of_one_and_of_t_are_finite():
    """Rows of one frame (one key read) beside full rows: the loss, every
    gradient and the logits of every frame, padded queries included, are
    finite."""
    model = _model()
    inputs = _inputs(pad=None)
    lengths = torch.tensor([1, T, 1, T], dtype=torch.int32)
    loss, grads = _loss_and_grads(model, inputs, lengths)
    assert torch.isfinite(loss)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    ctx = model.encode_context(inputs[1], inputs[2])
    logits = model.transition_model.transition_logits(ctx, lengths=lengths)
    assert bool(torch.isfinite(logits).all())
    # The logits a row of one frame gives at its first frame are those of
    # the row alone.
    alone = model.transition_model.transition_logits(ctx[:1, :1])
    torch.testing.assert_close(logits[:1, :1], alone, **CUT)


# -- the wrapper ------------------------------------------------------------------


def test_masked_attention_reads_each_rows_keys_only():
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((3, 9, 2, 4), generator=gen, dtype=torch.float64) for _ in range(3))
    lengths = torch.tensor([9, 1, 5])
    out = ops.masked_attention(q, k, v, lengths)
    for b, n in enumerate(lengths.tolist()):
        w = torch.softmax(torch.einsum("qhd,khd->hqk", q[b], k[b, :n]), dim=-1)
        torch.testing.assert_close(out[b], torch.einsum("hqk,khd->qhd", w, v[b, :n]), **CUT)
    assert torch.equal(ops.masked_attention(q, k, v), ops.masked_attention_reference(q, k, v))


def test_counters_count_calls_and_masked_keys():
    model = _model()
    inputs = _inputs()
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    calls, masked = attention.attention_calls, attention.attention_masked_keys
    _loss_and_grads(model, inputs, lengths)
    layers = CFG["num_transformer_layers"]
    assert attention.attention_calls == calls + layers
    assert attention.attention_masked_keys == masked + layers * (B * T - sum(LENGTHS))
    _loss_and_grads(model, inputs, None)
    assert attention.attention_calls == calls + 2 * layers
    assert attention.attention_masked_keys == masked + layers * (B * T - sum(LENGTHS))


@pytest.mark.parametrize("bad", ["shape", "dtype", "stride"])
def test_cuda_branch_checks_refuse_before_the_launch(bad):
    """The CUDA branch's checks (run here on meta tensors, which take that
    branch) raise under ``kernels.attention`` rather than run anything."""
    q = torch.empty((2, 8, 2, 4), device="meta")
    k, v = q.clone(), q.clone()
    if bad == "shape":
        k = torch.empty((2, 7, 2, 4), device="meta")
    elif bad == "dtype":
        q, k, v = (torch.empty((2, 8, 2, 4), device="meta", dtype=torch.int32) for _ in range(3))
    else:
        v = torch.empty((2, 8, 4, 2), device="meta").transpose(-1, -2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises((ValueError, TypeError), match="masked_attention"):
            ops.masked_attention(q, k, v)
    names = [e.name for e in prof.events()]
    assert "ops.attention" in names and "kernels.attention" in names


def test_encoder_spans_nest_under_a_cpu_profile():
    """``models.neural.encoder`` opens once a step under the transitions,
    ``ops.attention`` once a block under it; ``kernels.attention`` opens on
    the card's branch only."""
    model = _model()
    x, ph, pros = _inputs()
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.compute_loss(x, model.encode_context(ph, pros), lengths=lengths).backward()
    events = [e for e in prof.events() if e.name in ("models.neural.encoder", "ops.attention",
                                                      "kernels.attention")]
    names = [e.name for e in events]
    assert names.count("models.neural.encoder") == 1
    assert names.count("ops.attention") == CFG["num_transformer_layers"]
    assert "kernels.attention" not in names
    for e in events:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("models."):
            parent = parent.cpu_parent
        want = "models.neural.transitions" if e.name == "models.neural.encoder" else (
            "models.neural.encoder")
        assert parent is not None and parent.name == want, (e.name, parent)


# -- moved from tests/test_torch_neural_reference.py: the transformer's cases -----


@pytest.mark.parametrize("case", ["transformer"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_unpacked_calls_run_the_padded_route(case, mode):
    """A ragged call with attention transitions packs nothing: every entry
    point gives, bit for bit, what the padded route's scores give with the
    encoder's keys masked by ``lengths``, and the mask moves the valid
    frames' transitions."""
    model = _model(contextual=False).train(mode == "train")
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((B, T, D), generator=gen, dtype=torch.float64)
    ctx = torch.randn((B, T, 5), generator=gen, dtype=torch.float64)
    calls, skipped = neural.pack_calls, neural.pack_rows_skipped
    ll = model.compute_likelihood(x, ctx, lengths=lengths)
    path, score = model.viterbi_decode(x, ctx, lengths=lengths)
    post = model(x, ctx, lengths=lengths)
    assert (neural.pack_calls, neural.pack_rows_skipped) == (calls, skipped)
    la = model._log_transitions(ctx, lengths=lengths)
    args = (model.observation_model.log_probs(x), la, model._log_pi())
    assert torch.equal(ll, ops.auto_log_likelihood(*args, lengths))
    want_path, want_score = ops.auto_viterbi(*(a.detach() for a in args), lengths)
    assert torch.equal(path, want_path) and torch.equal(score, want_score)
    want = ops.auto_forward_backward(*(a.detach() for a in args), lengths)
    assert all(torch.equal(p, torch.exp(w)) for p, w in zip(post, want[:3]))
    params = [p for p in model.parameters() if p.requires_grad]
    got = torch.autograd.grad(ll.sum(), params, allow_unused=True, retain_graph=True)
    ref_grads = torch.autograd.grad(ops.auto_log_likelihood(*args, lengths).sum(), params,
                                    allow_unused=True)
    assert all((g is None and h is None) or torch.equal(g, h) for g, h in zip(got, ref_grads))
    # Rows shorter than T read fewer keys than the unmasked encoder, so their
    # valid frames' matrices move; the full row's do not.
    unmasked = model._log_transitions(ctx)
    assert torch.equal(la[0], unmasked[0])
    assert not torch.allclose(la[1, 1:LENGTHS[1]], unmasked[1, 1:LENGTHS[1]])


# -- the family: seeds, weights, counts ---------------------------------------------


@pytest.mark.parametrize("what", ["weights", "pool"])
def test_weights_and_pool_are_the_seeds(what):
    traffic = {"batch": 4, "min_frames": 20, "max_frames": 60, "pool": 2}

    def pool(seed):
        gen = torch.Generator().manual_seed(seed)
        w = fam.weights(CFG, gen, torch.device("cpu"))
        return w, harness.Pool(fam, CFG, traffic, w, gen, torch.device("cpu"))

    (w1, a), (w2, b), (w3, c) = pool(SEED), pool(SEED), pool(SEED + 1)
    if what == "weights":
        assert all(torch.equal(w1[k], w2[k]) for k in w1)
        assert not torch.equal(w1[ref.OUTPUT + ".weight"], w3[ref.OUTPUT + ".weight"])
        model = fam.program(CFG, w1, torch.device("cpu"))
        assert set(w1) == {k for k, _ in model.named_parameters()}
        ln = [v for k, v in w1.items() if ".ln" in k and k.endswith(".weight")]
        assert len(ln) == 2 * CFG["num_transformer_layers"]
        assert all(abs(float(t.mean()) - 1.0) < 0.1 for t in ln)
        return
    assert torch.equal(a.obs, b.obs) and torch.equal(a.lengths, b.lengths)
    assert not torch.equal(a.obs, c.obs)
    assert a.obs.shape[-1] == D + 1 + P


@pytest.mark.parametrize("what", ["flops", "shapes", "neural_attention"])
def test_counts_by_hand(what):
    cell = harness.json.loads((Path(harness.ROOT) / "bench_torch" / "configs"
                               / "ctxneural_tfm3_s12_h256_d80.json").read_text())
    if what == "flops":
        s = nfam.shapes(cell, [1])
        # in_proj 80x256, 18 products of 256x256, the output layer 268x144,
        # each 2 forward and 4 backward a multiply-add; the prosody (16x16)
        # and the trunk's first (80x256) without their input gradients; the
        # emissions' other products as the MLP configuration's.
        products = (6 * (80 * 256 + 18 * 256 * 256 + 268 * 144 + 256 * 256 + 2 * 256 * 80
                         + 3 * 80 * 12) + 4 * (16 * 16 + 80 * 256))
        assert fam.product_flops(s, 3) == products == 8_171_520
        # A layer forward 4·256 a key, 3x with the backward, 3 layers.
        attn = 3 * 3 * 4 * 256 * cell["attention_keys_per_frame"]
        rest = nfam.flops_per_frame(cell, "train") - nfam.product_flops(s)
        assert rest == 1584 + 1296 + 864 + 864 + 60
        assert math.isclose(fam.flops_per_frame(cell, "train"), products + attn + rest)
        assert round(attn) == 6_459_832
        return
    if what == "shapes":
        s = fam.shapes(cell, [1000, 250])
        assert s == {"B": 2, "frames": 1250, "rows": 2000, "D": 80, "K": 12, "H": 256, "C": 80,
                     "P": 16, "sum_sq": 1_062_500, "layers": 3, "heads": 8}
        # The configuration's keys a frame are train.b512's Σ L² / Σ L.
        gen = torch.Generator().manual_seed(SEED)
        traffic = harness.json.loads((Path(harness.HERE) / "traffic" / "train.b512.json")
                                     .read_text())
        lens = walks.lengths(traffic, gen, "cpu").double()
        assert math.isclose(float((lens ** 2).sum() / lens.sum()),
                            cell["attention_keys_per_frame"], rel_tol=1e-12)
        return
    mod = harness._load_file(Path(harness.HERE) / "rooflines" / f"{what}.py", f"k_{what}")
    assert harness.metric_reader(f"{what}_roofline") is not None
    tiny = {"frames": 10, "sum_sq": 58, "layers": 3, "heads": 2, "H": 8}
    # 3 layers, 2 heads of 4: 12 a pair and feature; bytes 8 tensors of
    # 10 frames x 8 floats a layer.
    got = mod.work(tiny)
    assert math.isclose(got[1] * mod.LAUNCHES, 3 * 2 * 12 * 4 * 58)
    assert math.isclose(got[0] * mod.LAUNCHES, 3 * 8 * 4 * 8 * 10)
    assert harness.roofline_pct(mod, harness.SimpleNamespace(calls=[], ops=[])) is None
