"""Ported ``core.viterbi`` (torch) vs ``pytorch_hmm_tpu.core.viterbi``.

Same numpy inputs into both; paths must be identical (lowest-index ties,
padded frames repeating the last valid state) and scores within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu import core as jcore
from pytorch_hmm_tpu_torch import core as tcore


def _k_problem(B, T, K, seed=None):
    rng = np.random.default_rng(B * T if seed is None else seed)
    lo = rng.normal(size=(B, T, K)).astype(np.float32)
    la = np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    return lo, la, lp


def _ties():
    K = 6
    lo = np.zeros((2, 40, K), np.float32)
    la = np.full((K, K), -np.log(K), np.float32)
    lp = np.full((K,), -np.log(K), np.float32)
    return lo, la, lp


def _bracketed_ties():
    K = 4
    a = np.full((K, K), 1.0 / (K - 1))
    np.fill_diagonal(a, 0.0)
    la = np.log(a + 1e-300).astype(np.float32)
    lp = np.full((K,), -np.log(K), np.float32)
    lo = np.zeros((2, 50, K), np.float32)
    return lo, la, lp


def assert_same_decode(lo, la, lp, lengths=None):
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    s_j, sc_j = jcore.viterbi(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp), jl)
    tl = None if lengths is None else torch.as_tensor(np.asarray(lengths, np.int32))
    s_t, sc_t = tcore.viterbi(torch.from_numpy(lo), torch.from_numpy(la),
                              torch.from_numpy(lp), tl)
    assert s_t.dtype == torch.int32 and tuple(s_t.shape) == lo.shape[:2]
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-5)
    return s_t, sc_t


@pytest.mark.parametrize(
    "shape", [(5, 300, 11), (3, 64, 5), (4, 128, 32), (1, 1, 3), (2, 500, 12)]
)
def test_viterbi_matches_jax(shape):
    assert_same_decode(*_k_problem(*shape))


@pytest.mark.parametrize("make", [_ties, _bracketed_ties], ids=["all", "bracketed"])
def test_viterbi_ties_match_jax(make):
    assert_same_decode(*make())


def test_viterbi_ragged_matches_jax_and_solo():
    lo, la, lp = _k_problem(5, 300, 9, seed=3)
    lengths = [300, 31, 164, 1, 129]
    s_t, sc_t = assert_same_decode(lo, la, lp, lengths)
    for b, n in enumerate(lengths):
        s_solo, sc_solo = tcore.viterbi(torch.from_numpy(lo[b:b + 1, :n]),
                                        torch.from_numpy(la), torch.from_numpy(lp))
        assert torch.equal(s_t[b, :n], s_solo[0])
        assert torch.all(s_t[b, n - 1:] == s_t[b, n - 1])
        np.testing.assert_allclose(sc_t[b].item(), sc_solo[0].item(), atol=1e-5)


def test_viterbi_single_frame_batch():
    lo, la, lp = _k_problem(3, 1, 7, seed=11)
    assert_same_decode(lo, la, lp)
    assert_same_decode(lo, la, lp, [1, 1, 1])


def test_viterbi_rejects_time_varying_transitions():
    """Time-varying transitions must be ``(B, T, K, K)`` for ``(B, T, K)``
    log-obs; any other batched shape is refused before any work."""
    lo, la, lp = _k_problem(2, 5, 3)
    for shape in ((2, 4, 3, 3), (1, 5, 3, 3), (5, 3, 3)):
        la_tv = np.broadcast_to(la, shape).copy()
        with pytest.raises(ValueError, match=r"\(K, K\) or \(B, T, K, K\)"):
            tcore.viterbi(torch.from_numpy(lo), torch.from_numpy(la_tv), torch.from_numpy(lp))


def _tv_problem(B, T, K, seed, neg_inf=False):
    """Log-obs and per-frame log transitions ``(B, T, K, K)``; with
    ``neg_inf`` a left-to-right band (self-loop, one step and two steps
    forward) whose other entries are -inf, one band per frame."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(B, T, K)).astype(np.float32)
    logits = rng.normal(size=(B, T, K, K))
    if neg_inf:
        i = np.arange(K)
        band = (i[None, :] >= i[:, None]) & (i[None, :] <= i[:, None] + 2)
        logits = np.where(band, logits, -np.inf)
    la = logits - np.log(np.sum(np.exp(logits), axis=-1, keepdims=True))
    lp = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    return lo, la.astype(np.float32), lp


@pytest.mark.parametrize("case", ["plain", "ragged", "K=32", "-inf band", "T=1"])
def test_time_varying_viterbi_matches_jax(case):
    """Time-varying transitions, bit-identical to the JAX scan: paths and
    scores, with ragged lengths (a length-1 row) and -inf entries."""
    B, T, K, lengths, neg = {
        "plain": (3, 60, 7, None, False),
        "ragged": (5, 40, 9, [40, 3, 1, 39, 17], False),
        "K=32": (2, 30, 32, None, False),
        "-inf band": (3, 50, 6, [50, 20, 49], True),
        "T=1": (2, 1, 4, None, False),
    }[case]
    lo, la, lp = _tv_problem(B, T, K, seed=B * T * K, neg_inf=neg)
    s_t, sc_t = assert_same_decode(lo, la, lp, lengths)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    _, sc_j = jcore.viterbi(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp), jl)
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))


def test_time_varying_viterbi_ties_and_frame_zero():
    """All-tie frames keep the lowest predecessor; frame 0's matrix is
    never read, so changing it changes nothing."""
    K = 5
    lo = np.zeros((2, 30, K), np.float32)
    la = np.full((2, 30, K, K), -np.log(K), np.float32)
    lp = np.full((K,), -np.log(K), np.float32)
    s_t, sc_t = assert_same_decode(lo, la, lp)
    la2 = la.copy()
    la2[:, 0] = np.random.default_rng(0).normal(size=(2, K, K))
    s2, sc2 = assert_same_decode(lo, la2, lp)
    assert torch.equal(s_t, s2) and torch.equal(sc_t, sc2)
    assert int(s_t.max()) == 0


def test_semiring_matches_jax():
    from pytorch_hmm_tpu.core import semiring as js
    from pytorch_hmm_tpu_torch.core import semiring as ts

    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 6)).astype(np.float32)
    x[0, 0] = -np.inf  # an all -inf row stays -inf
    np.testing.assert_allclose(ts.logsumexp(torch.from_numpy(x), dim=-1).numpy(),
                               np.asarray(js.logsumexp(jnp.asarray(x), axis=-1)),
                               atol=1e-6)
    v = rng.normal(size=(3, 6)).astype(np.float32)
    a = np.log(rng.dirichlet(np.ones(6), size=6)).astype(np.float32)
    tv, ti = ts.max_matvec(torch.from_numpy(v), torch.from_numpy(a))
    jv, ji = js.max_matvec(jnp.asarray(v), jnp.asarray(a))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    p = rng.random(size=(5,)).astype(np.float32)
    p[0] = 0.0
    np.testing.assert_allclose(ts.safe_log(torch.from_numpy(p)).numpy(),
                               np.asarray(js.safe_log(jnp.asarray(p))), rtol=1e-6)
    assert ts.LOG_ZERO == js.LOG_ZERO
