"""CTC in the port (``pytorch_hmm_tpu_torch.alignment``) against the JAX
package on the same numpy inputs, on the CPU: the forward / backward
scans, the loss and its closed-form gradient, forced alignment, the
posterior alignment, the aligner modules, greedy and prefix-beam decode
and the decode utilities; the loss and its gradient against
``torch.nn.CTCLoss`` too.

Tolerances: alpha / beta atol 5e-4 at valid cells above -1e29 and the
log-likelihood rtol 1e-4 + atol 1e-3, the JAX kernel tests' own
(tests/test_ops_ctc.py); the loss Function's gradient atol 1e-4 against
the JAX custom VJP and against autograd through the plain scan (the JAX
test of its VJP, ``test_ctc_loss_grad_matches_autodiff_scan``); the loss
rtol 1e-5 and the logits gradient atol 1e-4 against ``nn.CTCLoss``
(tests/test_alignment.py); Viterbi alignments and scores, decodes and
utilities identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import pytorch_hmm_tpu.alignment as jal
from pytorch_hmm_tpu.alignment import ctc as jctc
from pytorch_hmm_tpu_torch import alignment as tal
from pytorch_hmm_tpu_torch.alignment import ctc as tctc
from test_torch_ops_ctc import CASES, ctc_problem

REDUCTIONS = ("mean", "sum", "none")
# Feasible problems (input length ≥ 2U+1 on every row), ragged with a
# zero-length target and repeated labels, one with the blank last.
FEASIBLE = {
    "ragged": (4, 30, 8, 5, 20, [30, 11, 24, 19], [5, 0, 3, 5], 0, True, False),
    "blank last": (3, 26, 7, 4, 21, [26, 21, 9], [4, 4, 1], 6, True, False),
}


def _problem(spec):
    B, T, C, U, seed, il, tl, blank, rep, ninf = spec
    return ctc_problem(B, T, C, U, seed, il, tl, blank, rep, ninf), blank


def _both(problem):
    return ([jnp.asarray(a) for a in problem], [torch.from_numpy(np.array(a)) for a in problem])


def _valid(il, tl, T, S):
    return ((np.arange(S)[None, None, :] < (2 * tl + 1)[:, None, None])
            & (np.arange(T)[None, :, None] < il[:, None, None]))


@pytest.mark.parametrize("name", list(CASES))
def test_scans_and_loss_match_jax(name):
    """The plain scans (the CPU path) against the JAX XLA scans: alpha,
    beta, the log-likelihood of feasible rows and the loss under each
    reduction."""
    problem, blank = _problem(CASES[name])
    (jlp, jtg, jil, jtl), (tlp, ttg, til, ttl) = _both(problem)
    want_a, want_ll = jal.ctc_forward_algorithm(jlp, jtg, jil, jtl, blank)
    got_a, got_ll = tal.ctc_forward_algorithm(tlp, ttg, til, ttl, blank)
    want_b = jal.ctc_backward_algorithm(jlp, jtg, jil, jtl, blank)
    got_b = tal.ctc_backward_algorithm(tlp, ttg, til, ttl, blank)
    _, _, il, tl = problem
    for got, want in ((got_a, want_a), (got_b, want_b)):
        want = np.asarray(want)
        sel = _valid(il, tl, *want.shape[1:]) & (want > -1e29)
        np.testing.assert_allclose(got.numpy()[sel], want[sel], atol=5e-4)
    feasible = il >= 2 * tl + 1
    np.testing.assert_allclose(got_ll.numpy()[feasible], np.asarray(want_ll)[feasible],
                               rtol=1e-4, atol=1e-3)
    if feasible.all():
        for red in REDUCTIONS:
            np.testing.assert_allclose(
                tal.ctc_loss(tlp, ttg, til, ttl, blank, red).numpy(),
                np.asarray(jal.ctc_loss(jlp, jtg, jil, jtl, blank, red)), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", list(FEASIBLE))
@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_loss_gradient_matches_jax_vjp_and_autograd_through_the_scan(name, reduction):
    problem, blank = _problem(FEASIBLE[name])
    (jlp, jtg, jil, jtl), (tlp, ttg, til, ttl) = _both(problem)
    weights = np.linspace(0.5, 1.5, problem[0].shape[1]).astype(np.float32)

    def reduce_j(x):
        return jnp.sum(x * weights) if reduction == "none" else x

    want_loss, want_g = jax.value_and_grad(
        lambda x: reduce_j(jal.ctc_loss(x, jtg, jil, jtl, blank, reduction)))(jlp)
    x = tlp.clone().requires_grad_(True)
    loss = tal.ctc_loss(x, ttg, til, ttl, blank, reduction)
    loss = (loss * torch.from_numpy(weights)).sum() if reduction == "none" else loss
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-4)
    # Autograd through the plain forward scan, the same reduction.
    y = tlp.clone().requires_grad_(True)
    nll = -tal.ctc_forward_algorithm(y, ttg, til, ttl, blank)[1]
    if reduction == "mean":
        auto = torch.mean(nll / ttl.clamp_min(1))
    else:
        auto = nll.sum() if reduction == "sum" else (nll * torch.from_numpy(weights)).sum()
    auto.backward()
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=1e-4)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_loss_and_gradient_match_torch_ctc_loss(reduction):
    """``nn.CTCLoss``'s backward is the logits-space gradient, so both go
    through ``log_softmax`` of the same logits."""
    B, T, C, U = 4, 30, 8, 5
    rng = np.random.default_rng(22)
    logits = rng.normal(size=(T, B, C)).astype(np.float32)
    targets = torch.from_numpy(rng.integers(1, C, size=(B, U)).astype(np.int64))
    targets[0, :4] = torch.tensor([2, 2, 5, 5])
    il, tl = torch.tensor([30, 11, 24, 19]), torch.tensor([5, 0, 3, 5])
    x = torch.from_numpy(logits).requires_grad_(True)
    y = torch.from_numpy(logits).requires_grad_(True)
    ours = tal.ctc_loss(torch.log_softmax(x, -1), targets, il, tl, reduction=reduction)
    ref = torch.nn.CTCLoss(blank=0, reduction=reduction)(torch.log_softmax(y, -1), targets, il, tl)
    ours.backward()
    ref.backward()
    np.testing.assert_allclose(ours.item(), ref.item(), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_viterbi_alignment_and_posterior_path_match_jax(name):
    """Forced alignment bit for bit (tokens and scores, padded frames
    included) and the posterior-argmax path, per row."""
    problem, blank = _problem(CASES[name])
    (jlp, jtg, jil, jtl), (tlp, ttg, til, ttl) = _both(problem)
    want_ali, want_score = jal.ctc_viterbi_alignment(jlp, jtg, jil, jtl, blank)
    got_ali, got_score = tal.ctc_viterbi_alignment(tlp, ttg, til, ttl, blank)
    np.testing.assert_array_equal(got_ali.numpy(), np.asarray(want_ali))
    np.testing.assert_array_equal(got_score.numpy(), np.asarray(want_score))
    _, _, il, tl = problem
    want = jal.ctc_alignment_path(jlp, jtg, jil, jtl, blank)
    got = tal.ctc_alignment_path(tlp, ttg, til, ttl, blank)
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        if il[b] >= 2 * tl[b] + 1:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"row {b}")
        assert g.shape == (il[b],)


def test_aligner_modules_match_jax():
    """``CTCAligner`` loss (each reduction), ``align``, ``decode`` greedy
    and beam, ``decode_batch``; ``CTCSegmentationAligner`` with detected
    and given boundaries."""
    problem, blank = _problem(FEASIBLE["ragged"])
    (jlp, jtg, jil, jtl), (tlp, ttg, til, ttl) = _both(problem)
    for red in REDUCTIONS:
        ja, ta = jal.CTCAligner(8, reduction=red), tal.CTCAligner(8, reduction=red, device="cpu")
        np.testing.assert_allclose(ta(tlp, ttg, til, ttl).numpy(),
                                   np.asarray(ja(jlp, jtg, jil, jtl)), rtol=1e-4, atol=1e-3)
    ja, ta = jal.CTCAligner(8), tal.CTCAligner(8, device="cpu")
    for g, w in zip(ta.align(tlp, ttg, til, ttl), ja.align(jlp, jtg, jil, jtl)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for width in (1, 3):
        got, want = ta.decode(tlp, til, width), ja.decode(jlp, jil, width)
        assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
        for g, w in zip(ta.decode_batch(tlp, til, width), ja.decode_batch(jlp, jil, width)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng = np.random.default_rng(3)
    lp = rng.normal(size=(300, 5)).astype(np.float32)
    text = rng.integers(1, 5, size=(30,))
    kw = dict(num_classes=5, min_segment_length=50, max_segment_length=100)
    js, ts = jal.CTCSegmentationAligner(**kw), tal.CTCSegmentationAligner(**kw, device="cpu")
    for bounds in (None, [40, 120, 260, 290]):
        want = js.segment_and_align(jnp.asarray(lp), jnp.asarray(text),
                                    None if bounds is None else jnp.asarray(bounds))
        got = ts.segment_and_align(torch.from_numpy(lp), torch.from_numpy(text),
                                   None if bounds is None else torch.tensor(bounds))
        assert len(got) == len(want)
        for (gl, gt, gs, ge), (wl, wt, ws, we) in zip(got, want):
            assert (gs, ge) == (ws, we)
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
            np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def test_aligners_hold_no_parameters():
    """Nothing for the bridge to carry: neither side holds a parameter."""
    assert not jax.tree_util.tree_leaves(nnx.state(jal.CTCAligner(40), nnx.Param))
    assert not jax.tree_util.tree_leaves(nnx.state(jal.CTCSegmentationAligner(40), nnx.Param))
    for aligner in (tal.CTCAligner(40, device="cpu"), tal.CTCSegmentationAligner(40, device="cpu")):
        assert list(aligner.parameters()) == [] and aligner.state_dict() == {}


def _decode_problem(T, B, C, seed, ties):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=2.0, size=(T, B, C))
    if ties:
        # Coarse logits: many exact ties inside each frame, between beams
        # and between candidates.
        logits = np.round(logits)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits, jnp.float32), -1))
    in_lens = np.asarray([T] + list(rng.integers(1, T + 1, size=B - 1)), np.int32)
    return lp, in_lens


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_beam_decode_matches_jax_and_the_host_oracle(width, ties):
    """Tokens and lengths identical to the JAX beam search (ties ranked by
    lower candidate index on both sides), and to the numpy prefix beam
    search where no ties blur its ranking."""
    lp, il = _decode_problem(12, 4, 5, 13 + width, ties)
    want = jal.beam_search_decode_batch(jnp.asarray(lp), jnp.asarray(il), beam_width=width)
    got = tal.beam_search_decode_batch(torch.from_numpy(lp), torch.from_numpy(il), beam_width=width)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if not ties:
        for b in range(lp.shape[1]):
            host = jctc._prefix_beam_search(lp[: il[b], b], width, blank_id=0)
            np.testing.assert_array_equal(got[0][b, : got[1][b]].numpy(), host)
            np.testing.assert_array_equal(tctc._prefix_beam_search(lp[: il[b], b], width, 0), host)


def test_beam_decode_large_vocabulary():
    """C=1024 at T=20, W=4, against JAX and the host oracle."""
    width = 4
    lp, il = _decode_problem(20, 2, 1024, 3, ties=False)
    want = jal.beam_search_decode_batch(jnp.asarray(lp), jnp.asarray(il), beam_width=width)
    got = tal.beam_search_decode_batch(torch.from_numpy(lp), torch.from_numpy(il), beam_width=width)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for b in range(2):
        host = jctc._prefix_beam_search(lp[: il[b], b], width, blank_id=0)
        np.testing.assert_array_equal(got[0][b, : got[1][b]].numpy(), host)


def test_beam_decode_max_tokens_and_blank_id():
    lp, il = _decode_problem(15, 3, 6, 7, ties=True)
    for kw in (dict(max_tokens=3), dict(blank_id=5)):
        want = jal.beam_search_decode_batch(jnp.asarray(lp), jnp.asarray(il), 3, **kw)
        got = tal.beam_search_decode_batch(torch.from_numpy(lp), torch.from_numpy(il), 3, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("blank_id", [0, 3])
def test_greedy_decode_matches_jax(ties, blank_id):
    lp, il = _decode_problem(25, 5, 6, 11, ties)
    il[-1] = 1
    want = jal.greedy_decode_batch(jnp.asarray(lp), jnp.asarray(il), blank_id)
    got = tal.greedy_decode_batch(torch.from_numpy(lp), torch.from_numpy(il), blank_id)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seq", [[0, 1, 1, 0, 2, 2, 2, 0, 1], [], [3], [0, 0, 0], [4, 4, 0, 4]])
def test_decode_utilities_match_jax(seq):
    j, t = jnp.asarray(seq, jnp.int32), torch.tensor(seq, dtype=torch.int32)
    for name in ("collapse_repeated_tokens", "ctc_decode_sequence"):
        assert getattr(tal, name)(t).tolist() == np.asarray(getattr(jal, name)(j)).tolist()
    for blank in (0, 4):
        assert tal.remove_ctc_blanks(t, blank).tolist() == \
            np.asarray(jal.remove_ctc_blanks(j, blank)).tolist()
        assert tal.ctc_decode_sequence(t, blank).tolist() == \
            np.asarray(jal.ctc_decode_sequence(j, blank)).tolist()
