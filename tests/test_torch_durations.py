"""The duration log-pmfs of the torch port against the JAX package on the
same numpy parameters: atol 1e-5 (f32 transcendental functions of two
libraries on values of magnitude ~10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu import durations as jd
from pytorch_hmm_tpu_torch import durations as td

S, D = 5, 12


def _params(n, seed, lo=0.5, hi=12.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, size=S).astype(np.float32) for _ in range(n)]


FAMILIES = {
    "gamma": ("gamma_duration_log_pmf", 2),
    "poisson": ("poisson_duration_log_pmf", 1),
    "weibull": ("weibull_duration_log_pmf", 2),
    "gaussian": ("gaussian_duration_log_pmf", 2),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("min_duration,normalize", [(1, False), (3, False), (4, True)])
def test_log_pmf_matches_jax(family, min_duration, normalize):
    name, n = FAMILIES[family]
    params = _params(n, seed=len(family) + min_duration)
    want = np.asarray(getattr(jd, name)(*(jnp.asarray(p) for p in params), D,
                                        min_duration=min_duration, normalize=normalize))
    got = getattr(td, name)(*(torch.from_numpy(p) for p in params), D,
                            min_duration=min_duration, normalize=normalize).numpy()
    assert got.shape == (S, D)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[:, : min_duration - 1]).all()
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-5, rtol=1e-6)
    if normalize:
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)


def test_duration_grid_and_finalize():
    assert torch.equal(td.duration_grid(4), torch.tensor([1.0, 2.0, 3.0, 4.0]))
    x = torch.zeros(2, 5)
    out = td.finalize_duration_log_pmf(x, min_duration=2, normalize=True)
    assert torch.isneginf(out[:, 0]).all()
    torch.testing.assert_close(torch.exp(out).sum(-1), torch.ones(2))
