"""The neural HMMs on ragged batches (``lengths``), and the benchmark's
plain contextual neural HMM (``bench_torch/reference/neural_hmm.py``) and
family (``bench_torch/families/neural_hmm.py``) as functions of the seed.

The port runs its CPU path here (``core``'s scans, the plain emission
products), in float64 where it is held to the reference, so that the two
differ by rounding alone.
"""

import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness  # noqa: E402
from bench_torch.families import neural_hmm as fam  # noqa: E402
from bench_torch.reference import neural_hmm as ref  # noqa: E402
from pytorch_hmm_tpu_torch import ContextualNeuralHMM, NeuralHMM  # noqa: E402
from pytorch_hmm_tpu_torch.models import neural  # noqa: E402

CFG = {"num_states": 6, "feature_dim": 8, "hidden_dim": 16, "phoneme_vocab_size": 10,
       "linguistic_context_dim": 8, "prosody_dim": 4, "transition_type": "mlp",
       "observation_type": "gaussian", "dropout": 0.0, "walk_max_dwell": 6}
SEED = 2**31 + 20
B, T = 3, 40
LENGTHS = [T, 1, 23]
# Both sides in float64 over the same sums in another order: the loss
# (|loss| ~ 1e2, 40 frames of ~12 terms) rounds at ~1e-14 relative, so
# 1e-10 leaves four orders; a gradient is a sum over B·T frames of
# posterior-weighted terms, each leaf held to 1e-8 of its norm.
LOSS_RTOL, GRAD_RTOL = 1e-10, 1e-8
# The CPU scans in float64 on a cut row and on the padded batch: the same
# operations on the same valid frames.
CUT = dict(rtol=1e-12, atol=1e-10)


def _packed(seed=SEED):
    """Seeded weights and one packed batch ``(B, T, D + 1 + P)`` with
    :data:`LENGTHS`, padding zero."""
    gen = torch.Generator().manual_seed(seed)
    w = fam.weights(CFG, gen, torch.device("cpu"))
    lengths = torch.tensor([LENGTHS], dtype=torch.int32)
    states = fam.frame_states(CFG, {"max_frames": T}, lengths, gen, torch.device("cpu"))
    from bench_torch.families import walks
    obs = walks.pad_zero(fam.observations(w, states, gen), lengths)[0]
    return w, obs, lengths[0]


def test_loss_and_gradients_match_the_reference():
    w, obs, lengths = _packed()
    model = fam.program(CFG, w, torch.device("cpu")).double()
    loss = fam.program_loss(model, obs.double(), lengths)
    names = list(ref.LEAVES)
    params = dict(model.named_parameters())
    got = torch.autograd.grad(loss, [params[k] for k in names])
    trainer = ref.Trainer(w, 1e-3, CFG["feature_dim"], CFG["prosody_dim"], torch.float64, "cpu")
    want_loss, want = trainer.loss_and_grads(obs, lengths)
    assert abs(loss.item() - want_loss.item()) <= LOSS_RTOL * abs(want_loss.item())
    for name, g, h in zip(names, got, want):
        assert h.norm() > 0, name
        assert (g - h).norm() <= GRAD_RTOL * h.norm(), name
    # The static matrix is read by nothing once a context is given.
    assert "hmm.transition_matrix" not in names
    assert params["hmm.transition_matrix"].grad is None


def test_reference_blocks_do_not_change_the_step(monkeypatch):
    w, obs, lengths = _packed()
    trainer = ref.Trainer(w, 1e-3, CFG["feature_dim"], CFG["prosody_dim"], torch.float64, "cpu")
    whole = trainer.loss_and_grads(obs, lengths)
    monkeypatch.setattr(ref, "BLOCK_ROWS", 1)
    rows = trainer.loss_and_grads(obs, lengths)
    torch.testing.assert_close(rows[0], whole[0], rtol=1e-14, atol=0)
    for a, b in zip(rows[1], whole[1]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-15)


def test_reference_recursion_matches_a_plain_loop():
    """``log Z`` of each row written out: the sum over all state paths of
    its valid frames, by brute force at a short length."""
    gen = torch.Generator().manual_seed(5)
    S, n = 3, 4
    lo = torch.randn((2, 6, S), generator=gen, dtype=torch.float64)
    la = torch.log_softmax(torch.randn((2, 6, S, S), generator=gen, dtype=torch.float64), -1)
    lp = torch.log_softmax(torch.randn(S, generator=gen, dtype=torch.float64), -1)
    lengths = torch.tensor([n, 1])
    got = ref.log_z(lo, la, lp, lengths)
    import itertools
    for b, L in enumerate(lengths.tolist()):
        terms = []
        for path in itertools.product(range(S), repeat=L):
            s = lp[path[0]] + lo[b, 0, path[0]]
            for t in range(1, L):
                s = s + la[b, t, path[t - 1], path[t]] + lo[b, t, path[t]]
            terms.append(s)
        torch.testing.assert_close(got[b], torch.logsumexp(torch.stack(terms), 0),
                                   rtol=1e-13, atol=0)


# -- lengths cut the padding out ---------------------------------------------------


def _model(kind, **net):
    """A NeuralHMM with static or time-varying transitions, or a
    ContextualNeuralHMM, in float64; ``net`` picks the networks
    (``transition_type``, ``observation_type``)."""
    kw = dict(hidden_dim=16, dropout=0.0, device="cpu", generator=torch.Generator().manual_seed(4),
              **net)
    S, D = CFG["num_states"], CFG["feature_dim"]
    if kind == "contextual":
        return ContextualNeuralHMM(S, D, 10, linguistic_context_dim=8, prosody_dim=4, **kw).double()
    return NeuralHMM(S, D, context_dim=0 if kind == "static" else 5, **kw).double()


def _inputs(kind, pad=0.0, seed=9):
    """Inputs of one batch, the frames past each row's length set to
    ``pad`` (or to fresh noise where ``pad`` is None)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T, CFG["feature_dim"]), generator=gen, dtype=torch.float64)
    extra = {"static": [], "dynamic": [torch.randn((B, T, 5), generator=gen,
                                                   dtype=torch.float64)],
             "contextual": [torch.randint(0, 10, (B, T), generator=gen),
                            torch.randn((B, T, 4), generator=gen, dtype=torch.float64)]}[kind]
    valid = torch.arange(T)[None] < torch.tensor(LENGTHS)[:, None]
    noise = torch.Generator().manual_seed(seed + 1)

    def padded(t):
        fill = (torch.randint_like(t, 0, 10) if not t.is_floating_point() and pad is None
                else torch.randn(t.shape, generator=noise, dtype=t.dtype) if pad is None
                else torch.full_like(t, pad))
        keep = valid.reshape(*valid.shape, *([1] * (t.ndim - 2)))
        return torch.where(keep, t, fill)

    return [padded(t) for t in (x, *extra)]


def _calls(model, kind, inputs, lengths):
    """``(log-likelihood, (states, score), (posteriors, alpha, beta))``."""
    if kind == "contextual":
        x, ph, pros = inputs
        ctx = model.encode_context(ph, pros)
        return (model.compute_likelihood(x, ctx, lengths=lengths),
                model.viterbi_decode(x, ctx, lengths=lengths),
                model.forward_with_context(x, ph, pros, lengths=lengths))
    x, *ctx = inputs
    ctx = ctx[0] if ctx else None
    return (model.compute_likelihood(x, ctx, lengths=lengths),
            model.viterbi_decode(x, ctx, lengths=lengths), model(x, ctx, lengths=lengths))


@pytest.mark.parametrize("kind", ["static", "dynamic", "contextual"])
def test_lengths_equal_each_row_cut_to_its_length(kind):
    model = _model(kind)
    inputs = _inputs(kind)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    ll, (states, score), post = _calls(model, kind, inputs, lengths)
    assert ll.requires_grad and states.dtype == torch.int32
    for b, L in enumerate(LENGTHS):
        cut = [t[b:b + 1, :L] for t in inputs]
        ll_b, (states_b, score_b), post_b = _calls(model, kind, cut, None)
        torch.testing.assert_close(ll[b:b + 1], ll_b, **CUT)
        torch.testing.assert_close(score[b:b + 1], score_b, **CUT)
        assert torch.equal(states[b:b + 1, :L], states_b)
        # Past its end a row repeats its last valid state.
        assert torch.all(states[b, L:] == states_b[0, -1])
        for p, q in zip(post, post_b):
            torch.testing.assert_close(p[b:b + 1, :L], q, **CUT)
    # lengths of every frame compute what no lengths computes.
    full = torch.full((B,), T, dtype=torch.int32)
    a, b = _calls(model, kind, inputs, full), _calls(model, kind, inputs, None)
    torch.testing.assert_close(a[0], b[0], **CUT)
    assert torch.equal(a[1][0], b[1][0])
    for p, q in zip((a[1][1], *a[2]), (b[1][1], *b[2])):
        torch.testing.assert_close(p, q, **CUT)


@pytest.mark.parametrize("kind", ["static", "dynamic", "contextual"])
def test_padding_changes_nothing(kind):
    model = _model(kind)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    zero = _calls(model, kind, _inputs(kind, 0.0), lengths)
    noise = _calls(model, kind, _inputs(kind, None), lengths)
    torch.testing.assert_close(zero[0], noise[0], **CUT)
    torch.testing.assert_close(zero[1][1], noise[1][1], **CUT)
    assert torch.equal(zero[1][0], noise[1][0])
    for p, q in zip(zero[2], noise[2]):
        torch.testing.assert_close(p, q, **CUT)
    # And the loss's gradient leaves the padding's inputs alone.
    x = _inputs(kind, None)
    x[0].requires_grad_(True)
    if kind == "contextual":
        loss = model.compute_loss(x[0], model.encode_context(x[1], x[2]), lengths=lengths)
    else:
        loss = model.compute_loss(x[0], x[1] if kind == "dynamic" else None, lengths=lengths)
    (g,) = torch.autograd.grad(loss, [x[0]])
    valid = torch.arange(T)[None] < lengths[:, None]
    assert torch.all(g[~valid] == 0) and torch.all(g[valid].abs().sum(-1) > 0)


# -- the packed route: the networks on the valid frames only ---------------------


def _context(model, kind, inputs):
    """``(features, context or None)`` of :func:`_inputs`."""
    if kind == "contextual":
        return inputs[0], model.encode_context(inputs[1], inputs[2])
    return inputs[0], inputs[1] if kind == "dynamic" else None


def _loss_and_grads(model, kind, inputs, lengths):
    loss = model.compute_loss(*_context(model, kind, inputs), lengths=lengths)
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss, grads


@pytest.mark.parametrize("kind, head", [("contextual", "gaussian"), ("contextual", "mixture"),
                                        ("static", "gaussian"), ("dynamic", "mixture")])
def test_packed_step_equals_each_row_run_alone(kind, head):
    """A ragged step on the packed route (rows of 40, 1 and 23 frames): its
    loss is the mean of each row's loss run alone on the frames it has,
    and each parameter's gradient the mean of theirs, in float64."""
    model = _model(kind, observation_type=head)
    inputs = _inputs(kind, pad=None)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    calls, skipped = neural.pack_calls, neural.pack_rows_skipped
    loss, grads = _loss_and_grads(model, kind, inputs, lengths)
    assert (neural.pack_calls, neural.pack_rows_skipped) == (calls + 1,
                                                             skipped + B * T - sum(LENGTHS))
    rows = [_loss_and_grads(model, kind, [t[b:b + 1, :L] for t in inputs], None)
            for b, L in enumerate(LENGTHS)]
    assert neural.pack_calls == calls + 1
    want = sum(r[0] for r in rows) / B
    assert abs(loss.item() - want.item()) <= LOSS_RTOL * abs(want.item())
    names = [k for k, _ in model.named_parameters()]
    for k, name in enumerate(names):
        # A row of one frame reads no transition: its networks get none.
        parts = [r[1][k] for r in rows if r[1][k] is not None]
        if grads[k] is None:
            assert not parts, name
            continue
        h = sum(parts) / B
        assert h.norm() > 0, name
        assert (grads[k] - h).norm() <= GRAD_RTOL * h.norm(), name
    assert (grads[names.index("transition_matrix")] is None) == (kind != "static")


@pytest.mark.parametrize("kind", ["contextual", "static"])
def test_packed_scores_are_finite_in_the_padding(kind):
    """The scattered scores hold 0 (emissions) and −log S (transitions,
    one frame on by the shift) in every padded frame; the valid frames
    are the padded route's."""
    model = _model(kind)
    inputs = _inputs(kind, pad=None)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    x, ctx = _context(model, kind, inputs)
    calls = neural.pack_calls
    lo, la, lp = model._dp_args(x, ctx, None, lengths)
    assert neural.pack_calls == calls + 1
    lo0, la0, lp0 = model._dp_args(x, ctx, None)
    assert neural.pack_calls == calls + 1
    valid = torch.arange(T)[None] < lengths[:, None]
    assert torch.isfinite(lo).all() and torch.isfinite(la).all()
    assert torch.all(lo[~valid] == 0)
    torch.testing.assert_close(lo[valid], lo0[valid], **CUT)
    torch.testing.assert_close(lp, lp0, rtol=0, atol=0)
    if kind == "static":
        torch.testing.assert_close(la, la0, rtol=0, atol=0)
        return
    # Entry t holds the matrix of frame t - 1: padded from frame L + 1 on.
    read = torch.arange(T)[None] <= lengths[:, None]
    assert torch.all(la[~read] == -math.log(CFG["num_states"]))
    torch.testing.assert_close(la[read], la0[read], **CUT)


_UNPACKED = {
    "no lengths": ("contextual", {}, None),
    "no padding": ("contextual", {}, [T] * B),
    "rnn": ("dynamic", {"transition_type": "rnn"}, LENGTHS),
    "autoregressive": ("contextual", {"observation_type": "autoregressive"}, LENGTHS),
}


@pytest.mark.parametrize("case", list(_UNPACKED))
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_unpacked_calls_run_the_padded_route(case, mode):
    """No ``lengths``, no padding, or a network that mixes frames: every
    entry point gives, bit for bit, what the padded route's scores give,
    and nothing packs. (The attention transitions' cases, whose padded
    route masks the keys, are in tests/test_torch_neural_transformer.py.)"""
    from pytorch_hmm_tpu_torch import ops

    kind, net, lens = _UNPACKED[case]
    model = _model(kind, **net).train(mode == "train")
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    x, ctx = _context(model, kind, _inputs(kind, pad=None))
    calls, skipped = neural.pack_calls, neural.pack_rows_skipped
    ll = model.compute_likelihood(x, ctx, lengths=lengths)
    path, score = model.viterbi_decode(x, ctx, lengths=lengths)
    post = model(x, ctx, lengths=lengths)
    assert (neural.pack_calls, neural.pack_rows_skipped) == (calls, skipped)
    args = (model.observation_model.log_probs(x), model._log_transitions(ctx), model._log_pi())
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


# -- the family: seeds, packing, counts -------------------------------------------


def _pool(seed, traffic=None):
    traffic = traffic or {"batch": 4, "min_frames": 20, "max_frames": 60, "pool": 2}
    gen = torch.Generator().manual_seed(seed)
    w = fam.weights(CFG, gen, torch.device("cpu"))
    return w, harness.Pool(fam, CFG, traffic, w, gen, torch.device("cpu"))


@pytest.mark.parametrize("what", ["weights", "pool"])
def test_weights_and_pool_are_the_seeds(what):
    (w1, a), (w2, b), (w3, c) = _pool(SEED), _pool(SEED), _pool(SEED + 1)
    if what == "weights":
        assert all(torch.equal(w1[k], w2[k]) for k in w1)
        assert not torch.equal(w1[ref.STATES], w3[ref.STATES])
        model = fam.program(CFG, w1, torch.device("cpu"))
        assert set(w1) == {k for k, _ in model.named_parameters()}
        return
    assert torch.equal(a.obs, b.obs) and torch.equal(a.lengths, b.lengths)
    assert not torch.equal(a.obs, c.obs)
    assert sorted(sum(a.lens, [])) == sorted(sum(c.lens, []))
    D, P = CFG["feature_dim"], CFG["prosody_dim"]
    assert a.obs.shape[-1] == D + 1 + P
    valid = torch.arange(60)[None, None] < a.lengths[..., None]
    assert torch.all(a.obs[~valid] == 0) and torch.all(a.obs[valid][:, :D].abs().sum(-1) > 0)


def test_the_program_splits_exactly_the_packed_context():
    w, pool = _pool(SEED)
    obs, lengths = pool.batch(1)
    D, P = CFG["feature_dim"], CFG["prosody_dim"]
    x, ph, pros = ref.unpack(obs, D, P)
    assert torch.equal(x, obs[..., :D]) and torch.equal(pros, obs[..., D + 1:])
    assert ph.dtype == torch.int64 and torch.equal(ph.to(obs.dtype), obs[..., D])
    assert 0 <= int(ph.min()) and int(ph.max()) < CFG["phoneme_vocab_size"]
    # A segment holds one phoneme and one prosody vector: where the
    # prosody runs on, so does the phoneme; segments end inside each row.
    valid = torch.arange(obs.shape[1])[None] < lengths[:, None]
    same = (pros[:, 1:] == pros[:, :-1]).all(-1) & valid[:, 1:]
    assert torch.all((ph[:, 1:] == ph[:, :-1])[same])
    assert bool(same.any(1).all()) and bool((~same & valid[:, 1:]).any(1).all())
    model = fam.program(CFG, w, torch.device("cpu"))
    seen = {}
    hmm = model.hmm
    encode = hmm.encode_context

    def spy(phonemes, prosody):
        seen["ph"], seen["pros"] = phonemes, prosody
        return encode(phonemes, prosody)

    hmm.encode_context = spy
    loss = model.compute_loss(obs, lengths)
    assert torch.equal(seen["ph"], ph) and torch.equal(seen["pros"], pros)
    want = hmm.compute_loss(x, encode(ph, pros), lengths=lengths)
    torch.testing.assert_close(loss, want, rtol=0, atol=0)


@pytest.mark.parametrize("what", ["flops", "fbsum_smallk", "neural_matmul"])
def test_counts_by_hand(what):
    cell = harness.json.loads((Path(harness.ROOT) / "bench_torch" / "configs"
                               / "ctxneural_s12_h256_d80.json").read_text())
    s = fam.shapes(cell, [1000, 250])
    assert s == {"B": 2, "frames": 1250, "rows": 2000, "D": 80, "K": 12, "H": 256, "C": 80,
                 "P": 16}
    if what == "flops":
        # Products a frame: 256,064 multiply-adds, 2 forward and 4 backward
        # each, less the trunk's and the prosody's input gradients.
        assert fam.product_flops(s) == 6 * 256_064 - 2 * (80 * 256 + 16 * 16) == 1_494_912
        # Head 3 (6·80 + 4·12), log-softmax 9·144, chains 6·144, ξ 6·144, γ 5·12.
        assert fam.flops_per_frame(cell, "train") == 1_494_912 + 1584 + 1296 + 864 + 864 + 60
        with pytest.raises(ValueError):
            fam.flops_per_frame(cell, "decode")
        return
    mod = harness._load_file(Path(harness.HERE) / "rooflines" / f"{what}.py", f"k_{what}")
    assert harness.metric_reader(f"{what}_roofline") is not None
    tiny = {"B": 2, "frames": 10, "D": 3, "K": 2, "H": 4, "C": 5, "P": 1, "rows": 12}
    if what == "fbsum_smallk":
        # log-obs 20, transitions 40, log_pi 2, log Z 2, lengths 2, alpha and
        # beta 40: 4·106 bytes; two chains of 3 a predecessor: 2·10·2·3·2.
        assert mod.work(tiny) == (424, 240)
        return
    # Per frame (in, out, backward products): (1,1,1) (7,4,2) (4,4,2) (4,4,2)
    # (3,4,1) (4,4,2) (4,3,2) (4,3,2) (3,2,2) x3; per call (2,4,3,2) x2.
    per_frame = [(1, 1, 1), (7, 4, 2), (4, 4, 2), (4, 4, 2), (3, 4, 1), (4, 4, 2), (4, 3, 2),
                 (4, 3, 2), (3, 2, 2), (3, 2, 2), (3, 2, 2)]
    flops = sum(2 * 10 * i * o * (1 + n) for i, o, n in per_frame) + 2 * (2 * 2 * 4 * 3 * 3)
    nbytes = (sum(4 * (10 * i + i * o + 10 * o) * (1 + n) for i, o, n in per_frame)
              + 2 * 4 * (2 * 4 + 4 * 3 + 2 * 3) * 3)
    got = mod.work(tiny)
    assert math.isclose(got[1] * mod.LAUNCHES, flops) and math.isclose(got[0] * mod.LAUNCHES,
                                                                       nbytes)
    assert flops - 2 * (2 * 2 * 4 * 3 * 3) == 10 * fam.product_flops(tiny)
