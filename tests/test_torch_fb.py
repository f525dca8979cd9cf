"""``core/fb.py`` and the sum-product half of ``core/semiring.py`` ported
to torch, against the JAX package's ``core`` on the same numpy inputs.

Both sides run true f32 on the CPU. Tolerance atol 2e-4, the one the
JAX kernel tests hold their own kernels to against these scans
(``tests/test_ops_fbsum.py``); the associative forms reassociate the
logsumexps, which stays well inside it at these lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu import core as jcore
from pytorch_hmm_tpu_torch import core

ATOL = 2e-4


def _problem(B, T, K, seed, time_varying=False, batched_pi=False):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(B, T, K)).astype(np.float32)
    shape = (B, T, K, K) if time_varying else (K, K)
    la = np.log(rng.dirichlet(np.ones(K), size=shape[:-1])).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(K), size=(B,) if batched_pi else None)).astype(np.float32)
    return lo, la, lp


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _valid_close(got, want, lengths, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    if lengths is None:
        np.testing.assert_allclose(got, want, atol=atol)
        return
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=atol)


CASES = [
    # B, T, K, time_varying, batched_pi, lengths
    (3, 40, 5, False, False, None),
    (2, 64, 12, False, True, None),
    (4, 33, 6, False, False, [33, 20, 1, 7]),
    (3, 25, 4, True, False, None),
    (3, 30, 5, True, True, [30, 11, 2]),
    (2, 1, 3, False, False, None),
]


@pytest.mark.parametrize("method", ["scan", "associative"])
@pytest.mark.parametrize("B,T,K,tv,bpi,lengths", CASES)
def test_forward_backward_matches_jax(B, T, K, tv, bpi, lengths, method):
    """Alpha, beta, gamma and log Z, with JAX's freeze conventions past
    each row's end (alpha frozen, beta 0 from frame len-1): compared on
    every frame, padded ones included."""
    (lo_j, la_j, lp_j), (lo_t, la_t, lp_t) = _both(*_problem(B, T, K, B * T + K, tv, bpi))
    len_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    len_t = None if lengths is None else torch.tensor(lengths)

    want = jcore.forward_backward(lo_j, la_j, lp_j, len_j, method=method)
    got = core.forward_backward(lo_t, la_t, lp_t, len_t, method=method)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    np.testing.assert_allclose(
        core.log_likelihood(lo_t, la_t, lp_t, len_t, method=method).numpy(),
        np.asarray(jcore.log_likelihood(lo_j, la_j, lp_j, len_j, method=method)), atol=ATOL)

    lg, la_, lb, lz = got
    # The scan is the ground truth of both methods.
    if method == "associative":
        for g, w in zip(got[:3], core.forward_backward(lo_t, la_t, lp_t, len_t)[:3]):
            _valid_close(g.numpy(), w.numpy(), lengths)
    xi_t = core.xi_expectations(la_, lb, lo_t, la_t, lz)
    xi_j = jcore.xi_expectations(jnp.asarray(la_.numpy()), jnp.asarray(lb.numpy()),
                                 lo_j, la_j, jnp.asarray(lz.numpy()))
    np.testing.assert_allclose(xi_t.numpy(), np.asarray(xi_j), atol=ATOL)


def test_posteriors_normalise_and_xi_marginals():
    lo, la, lp = _problem(2, 30, 4, seed=3)
    lo, la, lp = map(torch.from_numpy, (lo, la, lp))
    lg, a, b, lz = core.forward_backward(lo, la, lp)
    np.testing.assert_allclose(torch.exp(lg).sum(-1).numpy(), 1.0, atol=1e-5)
    # Σ_j ξ_t[i, j] summed over t is Σ_{t<T-1} γ_t[i].
    xi = torch.exp(core.xi_expectations(a, b, lo, la, lz))
    np.testing.assert_allclose(xi.sum(-1).numpy(), torch.exp(lg[:, :-1]).sum(1).numpy(),
                               atol=1e-4)


def test_left_to_right_with_neg_inf_transitions_matches_jax():
    """Hard zeros in log_a stay -inf-safe: no NaN, and impossible states
    stay -inf exactly as in JAX."""
    K = 5
    a = 0.7 * np.eye(K) + 0.3 * np.eye(K, k=1)
    a[-1, -1] = 1.0
    with np.errstate(divide="ignore"):
        la = np.log(a).astype(np.float32)
        lp = np.log(np.eye(K)[0]).astype(np.float32)
    lo = np.random.default_rng(5).normal(size=(2, 20, K)).astype(np.float32)
    (lo_j, la_j, lp_j), (lo_t, la_t, lp_t) = _both(lo, la, lp)
    for method in ("scan", "associative"):
        got = core.forward_backward(lo_t, la_t, lp_t, method=method)
        want = jcore.forward_backward(lo_j, la_j, lp_j, method=method)
        for g, w in zip(got[1:], want[1:]):
            g, w = g.numpy(), np.asarray(w)
            assert not np.isnan(g).any()
            np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
            np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], atol=ATOL)


@pytest.mark.parametrize("name", ["log_matvec", "log_matvec_t", "log_matmul", "max_matmul"])
def test_semiring_products_match_jax(name):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 4, 4)).astype(np.float32)
    y = rng.normal(size=(3, 4, 4)).astype(np.float32)
    x[0, 1, :] = -np.inf                     # an all -inf row
    y[1, :, 2] = -np.inf
    if name == "log_matvec":
        args = (x[:, 0], y)
    elif name == "log_matvec_t":
        args = (y, x[:, 0])
    else:
        args = (x, y)
    want = getattr(jcore, name)(*(jnp.asarray(a) for a in args))
    got = getattr(core, name)(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert not torch.isnan(got).any()


def test_normalize_log_matches_jax():
    x = np.random.default_rng(2).normal(size=(3, 7)).astype(np.float32)
    x[1, 3] = -np.inf
    np.testing.assert_allclose(core.normalize_log(torch.from_numpy(x)).numpy(),
                               np.asarray(jcore.normalize_log(jnp.asarray(x))), atol=1e-6)
