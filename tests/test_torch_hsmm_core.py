"""The segment DP of the torch port (``core.hsmm``) against the JAX
``core.hsmm`` on the same numpy inputs.

* Viterbi: paths identical and scores equal, bit for bit (the port keeps
  the JAX scan's operand grouping and tie-breaks), ties and ragged rows
  included.
* Forward, backward, posteriors: atol 2e-5 (f32 recursions of ~T terms
  in two libraries; entries past a ragged row's end are unspecified and
  not compared).
* ``hsmm_log_z`` values and closed-form gradients against the JAX
  ``custom_vjp``: atol 2e-5, as ``tests/test_ops_hsmm.py`` holds the
  JAX VJP to autodiff; plus ``torch.autograd.gradcheck`` in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu.core import hsmm as jh
from pytorch_hmm_tpu_torch import core
from pytorch_hmm_tpu_torch.core import hsmm as th

ATOL = 2e-5


def _problem(B, T, S, D, seed, min_duration=1, uniform_pi=True):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(B, T, S)).astype(np.float32)
    a = rng.dirichlet(np.ones(S), size=S)
    np.fill_diagonal(a, 0.0)
    a = a / np.maximum(a.sum(axis=1, keepdims=True), 1e-30)
    la = np.log(a + 1e-12).astype(np.float32)
    lp = (np.full(S, -np.log(S)) if uniform_pi
          else np.log(rng.dirichlet(np.ones(S)))).astype(np.float32)
    ld = np.log(rng.dirichlet(np.ones(D), size=S) + 1e-12)
    if min_duration > 1:
        ld[:, : min_duration - 1] = -np.inf
    return lo, la, lp, ld.astype(np.float32)


def _ties(B=2, T=30, S=4, D=6):
    """Uniform emissions, transitions and durations: every segmentation
    with the same number of segments scores the same."""
    a = np.full((S, S), 1.0 / (S - 1))
    np.fill_diagonal(a, 0.0)
    with np.errstate(divide="ignore"):
        la = np.log(a).astype(np.float32)
    return (np.zeros((B, T, S), np.float32), la,
            np.full(S, -np.log(S), np.float32), np.full((S, D), -np.log(D), np.float32))


CASES = {
    "basic": (_problem(3, 50, 5, 7, 1), None),
    "T<D": (_problem(2, 12, 3, 20, 2), None),
    "min_duration=3": (_problem(3, 40, 6, 9, 3, min_duration=3, uniform_pi=False), None),
    "ragged": (_problem(4, 45, 6, 8, 4), [45, 23, 3, 1]),
    "S=1": (_problem(2, 10, 1, 12, 5), None),
    "ties": (_ties(), None),
    "ties ragged": (_ties(3, 25, 3, 5), [25, 9, 2]),
}


def _both(arrays, lengths):
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    return [jnp.asarray(a) for a in arrays], jl, [torch.from_numpy(a) for a in arrays], tl


def _frames(lengths, B, T):
    return lengths or [T] * B


@pytest.mark.parametrize("case", sorted(CASES))
def test_viterbi_bit_identical_to_jax(case):
    arrays, lengths = CASES[case]
    ja, jl, ta, tl = _both(arrays, lengths)
    s_j, c_j = jh.hsmm_viterbi(*ja, jl)
    s_t, c_t = th.hsmm_viterbi(*ta, tl)
    assert s_t.dtype == torch.int32
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    B, T = s_t.shape
    for b, n in enumerate(_frames(lengths, B, T)):
        assert torch.all(s_t[b, n - 1:] == s_t[b, n - 1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_backward_posteriors_match_jax(case):
    arrays, lengths = CASES[case]
    ja, jl, ta, tl = _both(arrays, lengths)
    a_j, z_j = jh.hsmm_forward(*ja, jl)
    a_t, z_t = th.hsmm_forward(*ta, tl)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=ATOL)
    bs_j, bt_j = jh.hsmm_backward(ja[0], ja[1], ja[3], jl)
    bs_t, bt_t = th.hsmm_backward(ta[0], ta[1], ta[3], tl)
    B, T, _ = arrays[0].shape
    for b, n in enumerate(_frames(lengths, B, T)):
        for got, want in ((a_t, a_j), (bs_t, bs_j), (bt_t, bt_j)):
            np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want)[b, :n], atol=ATOL)
    p_j = jh.hsmm_posteriors(*ja, jl)
    p_t = th.hsmm_posteriors(*ta, tl)
    for key in ("gamma", "segment_end", "segment_start", "log_z"):
        np.testing.assert_allclose(p_t[key].numpy(), np.asarray(p_j[key]), atol=ATOL, err_msg=key)
    valid = (np.arange(T)[None, :] < np.asarray(_frames(lengths, B, T))[:, None])
    np.testing.assert_allclose(p_t["gamma"].sum(-1).numpy()[valid], 1.0, atol=1e-5)


@pytest.mark.parametrize("lengths", [None, [40, 17, 3]])
def test_log_z_gradients_match_jax_custom_vjp(lengths):
    arrays = _problem(3, 40, 5, 9, 21, min_duration=3, uniform_pi=False)
    w = np.asarray([1.0, 2.0, -0.5], np.float32)
    ja, jl, _, tl = _both(arrays, lengths)
    want_v, want_g = jax.value_and_grad(
        lambda *a: jnp.sum(jh.hsmm_log_z(*a, jl) * w), argnums=(0, 1, 2, 3))(*ja)
    ta = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    val = torch.sum(core.hsmm_log_z(*ta, tl) * torch.from_numpy(w))
    val.backward()
    np.testing.assert_allclose(val.item(), float(want_v), rtol=1e-6)
    for name, t, g in zip(("obs", "a", "pi", "dur"), ta, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("lengths", [None, [7, 4]])
def test_log_z_functions_pass_gradcheck(lengths):
    """The closed-form backward against finite differences in float64
    (finite log_a and log_dur: the differences need a neighbourhood)."""
    rng = np.random.default_rng(5)
    B, T, S, D = 2, 7, 3, 4
    arrays = [rng.normal(size=s) for s in ((B, T, S), (S, S), (S,), (S, D))]
    args = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tl = None if lengths is None else torch.tensor(lengths)
    assert torch.autograd.gradcheck(lambda *a: core.hsmm_log_z(*a, tl), args, atol=1e-6)


def test_log_z_matches_autograd_through_the_forward():
    arrays = _problem(2, 30, 4, 6, 8)
    ta = [torch.from_numpy(a).double().requires_grad_(True) for a in arrays]
    tb = [torch.from_numpy(a).double().requires_grad_(True) for a in arrays]
    core.hsmm_log_z(*ta).sum().backward()
    core.hsmm_forward(*tb)[1].sum().backward()
    for x, y in zip(ta, tb):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-9, rtol=1e-7)


def test_ragged_rows_match_their_standalone_decode():
    lo, la, lp, ld = (torch.from_numpy(a) for a in _problem(3, 40, 5, 8, 13))
    lens = [40, 17, 29]
    states, score = core.hsmm_viterbi(lo, la, lp, ld, torch.tensor(lens))
    log_z = core.hsmm_forward(lo, la, lp, ld, torch.tensor(lens))[1]
    for b, n in enumerate(lens):
        s1, c1 = core.hsmm_viterbi(lo[b:b + 1, :n], la, lp, ld)
        assert torch.equal(states[b, :n], s1[0]) and torch.equal(score[b], c1[0])
        torch.testing.assert_close(log_z[b], core.hsmm_forward(lo[b:b + 1, :n], la, lp, ld)[1][0])
