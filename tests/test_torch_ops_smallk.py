"""``smallk_viterbi`` port: its plain version vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode on the CPU, as its own tests run
it. The CUDA kernel itself is checked against the same plain version on
the card by ``chip_smoke.py``; here the wrapper must take the plain path
for CPU tensors only, and raise (never fall back) for anything else.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu.ops.smallk import smallk_viterbi as jax_smallk_viterbi
from pytorch_hmm_tpu_torch import ops
from pytorch_hmm_tpu_torch.ops.smallk import (
    smallk_supported,
    smallk_viterbi,
    smallk_viterbi_reference,
)


def _problem(B, T, K, seed):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(B, T, K)).astype(np.float32)
    la = np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    return lo, la, lp


@pytest.mark.parametrize(
    "B,T,K,lengths",
    [(3, 64, 5, None), (4, 128, 32, None), (2, 200, 12, None),
     (5, 300, 9, [300, 31, 164, 1, 129])],
)
def test_reference_matches_jax_kernel(B, T, K, lengths):
    lo, la, lp = _problem(B, T, K, seed=B * T + K)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    s_j, sc_j = jax_smallk_viterbi(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp), jl)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    s_t, sc_t = smallk_viterbi_reference(torch.from_numpy(lo), torch.from_numpy(la),
                                         torch.from_numpy(lp), tl)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-5)


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    lo, la, lp = _problem(3, 50, 7, seed=1)
    args = [torch.from_numpy(a) for a in (lo, la, lp)]
    before = smallk_viterbi.launches
    s, sc = smallk_viterbi(*args)
    s0, sc0 = smallk_viterbi_reference(*args)
    assert torch.equal(s, s0) and torch.equal(sc, sc0)
    assert smallk_viterbi.launches == before


def test_wrapper_raises_off_cpu_instead_of_falling_back():
    lo = torch.empty(2, 10, 4, device="meta")
    la = torch.empty(4, 4, device="meta")
    lp = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        smallk_viterbi(lo, la, lp)
    with pytest.raises(ValueError, match="K <= 32"):
        smallk_viterbi(torch.empty(2, 10, 33, device="meta"),
                       torch.empty(33, 33, device="meta"),
                       torch.empty(33, device="meta"))


def test_smallk_supported_bounds():
    assert smallk_supported(1) and smallk_supported(12) and smallk_supported(32)
    assert not smallk_supported(33)
    assert not smallk_supported(0)


def test_auto_viterbi_on_cpu_matches_jax_beyond_kernel_range():
    """CPU tensors take the plain path at any K, like the JAX package's
    non-TPU branch."""
    from pytorch_hmm_tpu.ops import auto_viterbi as jax_auto_viterbi

    lo, la, lp = _problem(2, 40, 40, seed=4)
    s_j, sc_j = jax_auto_viterbi(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp))
    s_t, sc_t = ops.auto_viterbi(torch.from_numpy(lo), torch.from_numpy(la),
                                 torch.from_numpy(lp))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-5)
