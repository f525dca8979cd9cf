"""The CTC lattice chains (rows 20-23 of the JAX package's kernels): the
port's plain versions against ``pytorch_hmm_tpu.ops.ctc_kernel``'s
Pallas kernels in interpret mode on the same numpy inputs, on every
dispatch branch of the reference (the lane-tiled forward / backward at
S ≤ 512, the batch-packed wide layout at S=701, the one-row-per-program
wide layout, the resident and the streamed Viterbi), and the port's
envelope.

Cases: ragged lengths with a length-1 row, a zero-length target,
repeated labels (a forbidden skip), ``blank_id`` not 0, T=1, an
infeasible row (input length < 2U+1) and a ``-inf`` logit. Tolerances
are the JAX kernel tests' own (tests/test_ops_ctc.py): alpha / beta atol
5e-4 at valid cells (lattice position inside the target, frame inside
the input) whose value is above -1e29, log-likelihood rtol 1e-4 + atol
1e-3, Viterbi positions identical and scores atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_hmm_tpu.alignment.ctc as jctc
import pytorch_hmm_tpu.ops.ctc_kernel as jkern
import pytorch_hmm_tpu_torch.alignment.ctc as tctc
from pytorch_hmm_tpu_torch import ops
from pytorch_hmm_tpu_torch.ops import ctc_kernel as tkern

NEG = -1e30


def ctc_problem(B, T, C, U, seed, in_lens=None, tgt_lens=None, blank_id=0, repeats=False,
                neg_inf=False):
    """``(log_probs (T, B, C) f32, targets (B, U), in_lens, tgt_lens)``,
    numpy, from a seed. ``repeats`` gives row 0 runs of equal labels (the
    lattice forbids those skips); ``neg_inf`` puts a ``-inf`` logit on
    one of row 0's labels at frame 1."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, B, C)).astype(np.float32)
    labels = np.array([c for c in range(C) if c != blank_id])
    targets = rng.choice(labels, size=(B, U)).astype(np.int32)
    if repeats and U >= 4:
        targets[0, :4] = [labels[0], labels[0], labels[1], labels[1]]
    if neg_inf and U:
        logits[min(1, T - 1), 0, targets[0, 0]] = -np.inf
    log_probs = logits - np.logaddexp.reduce(logits, axis=-1, keepdims=True)
    in_lens = np.full(B, T, np.int32) if in_lens is None else np.asarray(in_lens, np.int32)
    tgt_lens = np.full(B, U, np.int32) if tgt_lens is None else np.asarray(tgt_lens, np.int32)
    return log_probs.astype(np.float32), targets, in_lens, tgt_lens


# name: (B, T, C, U, seed, in_lens, tgt_lens, blank_id, repeats, neg_inf)
CASES = {
    # Ragged with a length-1 row, a zero-length target, an infeasible row
    # (9 frames for 2U+1 = 13), repeated labels and a -inf logit.
    "ragged": (4, 40, 12, 6, 0, [40, 1, 23, 9], [6, 0, 4, 6], 0, True, True),
    "blank last": (3, 33, 9, 5, 1, [33, 20, 31], [5, 3, 1], 8, True, False),
    "T=1": (3, 1, 7, 3, 2, [1, 1, 1], [3, 0, 1], 0, False, False),
    "unragged": (2, 64, 30, 20, 3, None, None, 0, False, False),
}


def _pair(problem, blank_id):
    """The problem on both sides: JAX arrays and torch tensors."""
    lpr, tg, il, tl = problem
    return (jnp.asarray(lpr), jnp.asarray(tg), jnp.asarray(il), jnp.asarray(tl)), \
        (torch.from_numpy(lpr), torch.from_numpy(tg), torch.from_numpy(il), torch.from_numpy(tl))


def kernel_inputs(log_probs, targets, tgt_lens, blank_id):
    """The lattice kernels' inputs as the JAX ``alignment/ctc.py`` builds
    them (jnp): ``(lp, skip_add, skip_fwd, vmask, a0, bT, end1, end2)``."""
    expanded = jctc.expand_targets_with_blank(targets, blank_id)
    S = expanded.shape[1]
    skip_ok = jctc._lattice_masks(expanded, blank_id)
    s_idx = jnp.arange(S)[None, :]
    valid = s_idx < (2 * tgt_lens[:, None] + 1)
    lp = jctc._gather_emissions(log_probs, expanded)
    a0 = jnp.full((lp.shape[0], S), NEG).at[:, 0].set(lp[:, 0, 0])
    if S > 1:
        a0 = a0.at[:, 1].set(jnp.where(tgt_lens > 0, lp[:, 0, 1], NEG))
    a0 = jnp.where(valid, a0, NEG)
    e1, e2 = 2 * tgt_lens, jnp.maximum(2 * tgt_lens - 1, 0)
    bT = jnp.where((s_idx == e1[:, None]) | (s_idx == e2[:, None]), 0.0, NEG)
    skip_fwd = jnp.concatenate([skip_ok[:, 2:], jnp.zeros_like(skip_ok[:, :2])], 1)[:, :S]
    mask = lambda m: jnp.where(m, 0.0, NEG).astype(jnp.float32)
    return lp, mask(skip_ok), mask(skip_fwd), mask(valid), a0, bT, e1, e2


def _to_torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _valid_cells(il, tl, T, S):
    return ((np.arange(S)[None, None, :] < (2 * tl + 1)[:, None, None])
            & (np.arange(T)[None, :, None] < il[:, None, None]))


def _assert_tables_close(got, want, il, tl):
    got, want = got.numpy(), np.asarray(want)
    sel = _valid_cells(il, tl, *want.shape[1:]) & (want > -1e29)
    np.testing.assert_allclose(got[sel], want[sel], atol=5e-4)


def _both_inputs(name):
    """The case's problem, blank id and kernel inputs: JAX arrays and the
    same values as torch tensors, each with its input lengths."""
    B, T, C, U, seed, il, tl, blank, rep, ninf = CASES[name]
    problem = ctc_problem(B, T, C, U, seed, il, tl, blank, rep, ninf)
    (jlp, jtg, jil, jtl), _ = _pair(problem, blank)
    jin = kernel_inputs(jlp, jtg, jtl, blank)
    return problem, blank, (jin, jil), (_to_torch(jin), torch.from_numpy(problem[2]))


@pytest.mark.parametrize("name", list(CASES))
def test_lattice_helpers_match_jax(name):
    """The port's expanded labels, skip masks, gathered emissions (``-inf``
    clamped to -1e30), frame-0 row and additive masks equal the JAX
    package's."""
    problem, blank, (jin, _), _ = _both_inputs(name)
    lpr, tg, il, tl = (torch.from_numpy(a) for a in problem)
    _, ttl, expanded, skip_ok, valid, lp = tctc._lattice(lpr, tg, il, tl, blank)
    np.testing.assert_array_equal(
        expanded.numpy(), np.asarray(jctc.expand_targets_with_blank(jnp.asarray(tg), blank)))
    skip_add, vmask = tctc._masks(skip_ok, valid, lp.dtype)
    got = (lp, skip_add, vmask, tctc._initial_row(lp, valid, ttl))
    for g, w in zip(got, (jin[0], jin[1], jin[3], jin[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_backward_match_jax_lane_tiled(name):
    problem, _, (jin, jil), (tin, til) = _both_inputs(name)
    lp, skip_add, skip_fwd, vmask, a0, bT, _, _ = jin
    assert not jkern._use_wide(lp.shape[2], lp.shape[0])
    want_a = jkern.ctc_lattice_forward(lp, skip_add, vmask, a0, jil)
    want_b = jkern.ctc_lattice_backward(lp, skip_fwd, vmask, bT, jil)
    lp, skip_add, skip_fwd, vmask, a0, bT, _, _ = tin
    got_a = tkern.ctc_lattice_forward(lp, skip_add, vmask, a0, til)
    got_b = tkern.ctc_lattice_backward(lp, skip_fwd, vmask, bT, til)
    _, _, il, tl = problem
    _assert_tables_close(got_a, want_a, il, tl)
    _assert_tables_close(got_b, want_b, il, tl)
    # The frozen rows: each row past its length repeats its last alpha.
    for b, n in enumerate(il):
        if 0 < n < got_a.shape[1]:
            assert torch.equal(got_a[b, n:], got_a[b, n - 1:n].expand_as(got_a[b, n:]))


def _wide_problem():
    # S = 701 > 512: the reference's wide layouts; ragged, a length-1 row,
    # an empty target, an infeasible row, repeated labels.
    return ctc_problem(3, 150, 30, 350, 9, [150, 1, 97], [350, 0, 41], 0, True, False)


@pytest.mark.parametrize("packed", [True, False])
def test_forward_backward_match_jax_wide(packed, monkeypatch):
    """S=701: the batch-packed wide kernels, and (packing refused) the
    one-row-per-program wide kernels."""
    problem = _wide_problem()
    (jlp, jtg, jil, jtl), (_, _, til, _) = _pair(problem, 0)
    jin = kernel_inputs(jlp, jtg, jtl, 0)
    lp, skip_add, skip_fwd, vmask, a0, bT, _, _ = jin
    B, _, S = lp.shape
    assert jkern._use_wide(S, B) and jkern.ctc_wide_packed_supported(B, S)
    monkeypatch.setattr(jkern, "ctc_wide_packed_supported", lambda b, s: packed)
    jax.clear_caches()
    want_a = jkern.ctc_lattice_forward(lp, skip_add, vmask, a0, jil)
    want_b = jkern.ctc_lattice_backward(lp, skip_fwd, vmask, bT, jil)
    jax.clear_caches()
    lp, skip_add, skip_fwd, vmask, a0, bT, _, _ = _to_torch(jin)
    _, _, il, tl = problem
    _assert_tables_close(tkern.ctc_lattice_forward(lp, skip_add, vmask, a0, til), want_a, il, tl)
    _assert_tables_close(tkern.ctc_lattice_backward(lp, skip_fwd, vmask, bT, til), want_b, il, tl)


@pytest.mark.parametrize("name", list(CASES))
def test_viterbi_matches_jax_resident_and_wide(name):
    """Both JAX Viterbi kernels against the one plain Viterbi: positions
    identical, scores within 1e-4; the port's two wrappers run it on CPU
    tensors."""
    problem, _, (jin, jil), (tin, til) = _both_inputs(name)
    lp, skip_add, _, vmask, a0, _, e1, e2 = jin
    T, B, S = lp.shape[1], lp.shape[0], lp.shape[2]
    assert jkern.ctc_viterbi_kernel_supported(T, B, S) and jkern.ctc_viterbi_wide_supported(T, B, S)
    wants = [jkern.ctc_lattice_viterbi(lp, skip_add, vmask, a0, jil, e1, e2),
             jkern.ctc_lattice_viterbi_wide(lp, skip_add, vmask, a0, jil, e1, e2)]
    lp, skip_add, _, vmask, a0, _, e1, e2 = tin
    for fn in (tkern.ctc_lattice_viterbi, tkern.ctc_lattice_viterbi_wide):
        pos, score = fn(lp, skip_add, vmask, a0, til, e1, e2)
        assert pos.dtype == torch.int32 and pos.shape == (B, T)
        for want_pos, want_score in wants:
            np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
            np.testing.assert_allclose(score.numpy(), np.asarray(want_score), atol=1e-4)


def test_viterbi_matches_jax_wide_at_s701():
    """The streamed Viterbi's own regime (S > 512), ragged."""
    problem = _wide_problem()
    (jlp, jtg, jil, jtl), (_, _, til, _) = _pair(problem, 0)
    jin = kernel_inputs(jlp, jtg, jtl, 0)
    lp, skip_add, _, vmask, a0, _, e1, e2 = jin
    want_pos, want_score = jkern.ctc_lattice_viterbi_wide(lp, skip_add, vmask, a0, jil, e1, e2)
    lp, skip_add, _, vmask, a0, _, e1, e2 = _to_torch(jin)
    pos, score = tkern.ctc_lattice_viterbi_wide(lp, skip_add, vmask, a0, til, e1, e2)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_entry_points_on_the_kernel_route_match_jax(name, monkeypatch):
    """``ctc_forward_algorithm`` / ``ctc_backward_algorithm`` /
    ``ctc_viterbi_alignment`` with the kernel route forced on both sides
    (the port's wrappers run their plain versions on CPU tensors, the JAX
    kernels run in interpret mode)."""
    problem, blank, _, _ = _both_inputs(name)
    (jlp, jtg, jil, jtl), (tlp, ttg, til, ttl) = _pair(problem, blank)
    monkeypatch.setattr(jctc, "_use_ctc_kernels", lambda s, b: True)
    monkeypatch.setattr(tctc, "_use_ctc_kernels", lambda lp: True)
    want_a, want_ll = jctc.ctc_forward_algorithm(jlp, jtg, jil, jtl, blank)
    want_b = jctc.ctc_backward_algorithm(jlp, jtg, jil, jtl, blank)
    want_ali, want_score = jctc.ctc_viterbi_alignment(jlp, jtg, jil, jtl, blank)
    got_a, got_ll = tctc.ctc_forward_algorithm(tlp, ttg, til, ttl, blank)
    got_b = tctc.ctc_backward_algorithm(tlp, ttg, til, ttl, blank)
    got_ali, got_score = tctc.ctc_viterbi_alignment(tlp, ttg, til, ttl, blank)
    _, _, il, tl = problem
    _assert_tables_close(got_a, want_a, il, tl)
    _assert_tables_close(got_b, want_b, il, tl)
    feasible = il >= 2 * tl + 1
    np.testing.assert_allclose(got_ll.numpy()[feasible], np.asarray(want_ll)[feasible],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got_ali.numpy(), np.asarray(want_ali))
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score), atol=1e-4)


def test_envelope():
    """The reference's caps (S ≤ 2048, B ≤ 256) at any T; the resident
    Viterbi while T·S bytes fit shared memory, the streamed one at any T
    (the reference's streamed kernel is bounded by VMEM in T; the card's
    is not)."""
    assert tkern.ctc_lattice_supported(101, 16) and tkern.ctc_lattice_supported(2048, 256)
    assert not tkern.ctc_lattice_supported(2049, 4)
    assert not tkern.ctc_lattice_supported(101, 257)
    assert tkern.ctc_viterbi_kernel_supported(500, 16, 101)
    assert not tkern.ctc_viterbi_kernel_supported(2048, 4, 2001)
    assert tkern.ctc_viterbi_wide_supported(2048, 4, 2001)
    assert tkern.ctc_viterbi_wide_supported(1 << 20, 4, 2001)
    assert not tkern.ctc_viterbi_wide_supported(100, 4, 2049)
    assert {"ctc_lattice_forward", "ctc_lattice_backward", "ctc_lattice_viterbi",
            "ctc_lattice_viterbi_wide"} <= set(ops.__all__)


@pytest.mark.parametrize("fn,shape", [
    (tkern.ctc_lattice_viterbi, (4, 2048, 2001)),   # choice table past shared memory
    (tkern.ctc_lattice_forward, (4, 10, 2049)),     # S past the cap
    (tkern.ctc_lattice_backward, (257, 10, 5)),     # B past the cap
])
def test_wrappers_refuse_shapes_off_the_cpu_outside_their_envelope(fn, shape):
    """Off the CPU a wrapper launches its kernel or raises; these shapes
    raise before anything is built (meta tensors stand in for the card)."""
    B, _, S = shape
    lp = torch.empty(shape, device="meta")
    row = torch.empty((B, S), device="meta")
    il = torch.empty((B,), dtype=torch.int32, device="meta")
    args = (lp, row, row, row, il) + ((il, il) if fn is tkern.ctc_lattice_viterbi else ())
    with pytest.raises(ValueError):
        fn(*args)
