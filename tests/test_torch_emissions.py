"""Ported emission families (torch) vs ``pytorch_hmm_tpu.emissions``.

Both sides in true f32 (JAX on the CPU resolves to ``Precision.HIGHEST``;
torch with TF32 off); atol 1e-4, rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu import emissions as je
from pytorch_hmm_tpu_torch import emissions as te

ATOL, RTOL = 1e-4, 1e-5
B, T, S, C, D = 2, 37, 5, 3, 16


def _close(t, j):
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def _inputs(seed, cov_shape):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, T, D)).astype(np.float32)
    means = rng.normal(size=(S, C, D)).astype(np.float32)
    cov = (0.3 * rng.normal(size=cov_shape)).astype(np.float32)
    logits = rng.normal(size=(S, C)).astype(np.float32)
    return obs, means, cov, logits


def test_diag_gaussian_log_probs_matches_jax():
    obs, means, cov, _ = _inputs(0, (S * C, D))
    means = means.reshape(S * C, D)
    j = je.diag_gaussian_log_probs(jnp.asarray(obs), jnp.asarray(means), jnp.asarray(cov))
    t = te.diag_gaussian_log_probs(*(torch.from_numpy(a) for a in (obs, means, cov)))
    _close(t, j)


def test_spherical_gaussian_log_probs_matches_jax():
    obs, means, cov, _ = _inputs(1, (S * C,))
    means = means.reshape(S * C, D)
    j = je.spherical_gaussian_log_probs(jnp.asarray(obs), jnp.asarray(means), jnp.asarray(cov))
    t = te.spherical_gaussian_log_probs(*(torch.from_numpy(a) for a in (obs, means, cov)))
    _close(t, j)


@pytest.mark.parametrize(
    "cov_type,cov_shape",
    [("diag", (S, C, D)), ("tied", (D,)), ("spherical", (S, C))],
)
def test_gmm_log_probs_matches_jax(cov_type, cov_shape):
    obs, means, cov, logits = _inputs(2, cov_shape)
    jargs = [jnp.asarray(a) for a in (obs, means, cov, logits)]
    targs = [torch.from_numpy(a) for a in (obs, means, cov, logits)]
    _close(te.gmm_log_probs(*targs, cov_type), je.gmm_log_probs(*jargs, cov_type))
    _close(te.gmm_component_log_probs(*targs[:3], cov_type),
           je.gmm_component_log_probs(*jargs[:3], cov_type))


def test_full_covariance_raises_not_implemented():
    """Full covariance, once refused, now scores as the JAX package does:
    flattened Cholesky parameters ``(S, C, D(D+1)/2)`` through
    ``tril_from_flat``, the inverse factors and the expanded quadratic
    form (scores up to ~1e2 here: atol 1e-4, rtol 1e-5 as above; the
    inverse factors differ in method, see tests/test_torch_fullcov.py).
    An unknown covariance type still raises."""
    obs, means, cov, logits = _inputs(3, (S, C, D * (D + 1) // 2))
    cov[..., [i * (i + 1) // 2 + i for i in range(D)]] += 0.5413
    jargs = [jnp.asarray(a) for a in (obs, means, cov, logits)]
    targs = [torch.from_numpy(a) for a in (obs, means, cov, logits)]
    _close(te.gmm_log_probs(*targs, "full"), je.gmm_log_probs(*jargs, "full"))
    _close(te.gmm_component_log_probs(*targs[:3], "full"),
           je.gmm_component_log_probs(*jargs[:3], "full"))
    with pytest.raises(ValueError, match="Unknown"):
        te.gmm_log_probs(*targs, "banded")
