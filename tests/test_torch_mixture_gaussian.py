"""The decode slice as a whole: ``MixtureGaussianHMMLayer`` (torch) vs
``pytorch_hmm_tpu.models.MixtureGaussianHMMLayer`` (JAX).

The JAX layer is built from ``nnx.Rngs(0)``; its weights are read out as
numpy and carried into the torch layer through ``bridge``. Paths must be
identical on this fixed seed; scores within rtol 1e-5, atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_hmm_tpu.models import MixtureGaussianHMMLayer as JaxLayer
from pytorch_hmm_tpu_torch import MixtureGaussianHMMLayer, bridge
from pytorch_hmm_tpu_torch.ops.emit import diag_quadratic
from pytorch_hmm_tpu_torch.ops.smallk import smallk_viterbi

S, D, C = 5, 16, 3
B, T = 3, 60
LENGTHS = [60, 17, 1]

CASES = [("diag", True), ("diag", False), ("tied", True), ("tied", False),
         ("spherical", True)]


def _jax_params(layer) -> dict:
    names = ["mixture_weights_logits", "means", "cov_params",
             "transition_logits" if layer.learnable_transitions else "transition_matrix"]
    return {n: np.asarray(getattr(layer, n)[...]) for n in names}


@pytest.fixture(scope="module")
def obs():
    return np.random.default_rng(0).normal(size=(B, T, D)).astype(np.float32)


def _pair(cov_type, learnable):
    jl = JaxLayer(S, D, num_components=C, covariance_type=cov_type,
                  learnable_transitions=learnable, rngs=nnx.Rngs(0))
    tl = MixtureGaussianHMMLayer(S, D, num_components=C, covariance_type=cov_type,
                                 learnable_transitions=learnable, device="cpu")
    tl.load_state_dict(bridge.mixture_gaussian_state_dict(_jax_params(jl)))
    return jl, tl.eval()


def _same_decode(t_out, j_out):
    (ts, tsc), (js, jsc) = t_out, j_out
    assert ts.dtype == torch.int32 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("cov_type,learnable", CASES)
def test_decode_matches_jax(obs, cov_type, learnable):
    jl, tl = _pair(cov_type, learnable)
    o_j, o_t = jnp.asarray(obs), torch.from_numpy(obs)
    len_j, len_t = jnp.asarray(LENGTHS, jnp.int32), torch.tensor(LENGTHS)
    launches = diag_quadratic.launches, smallk_viterbi.launches

    _same_decode(tl(o_t, return_log_probs=True), jl(o_j, return_log_probs=True))
    _same_decode(tl(o_t, return_log_probs=True, lengths=len_t),
                 jl(o_j, return_log_probs=True, lengths=len_j))
    _same_decode(tl.make_decoder()(o_t, True, len_t),
                 jl.make_decoder()(o_j, True, len_j))
    states, score = tl(o_t)
    assert score is None and states.shape == (B, T)

    np.testing.assert_allclose(
        tl.get_observation_log_probs(o_t).detach().numpy(),
        np.asarray(jl.get_observation_log_probs(o_j)), atol=1e-4, rtol=1e-5)
    # CPU tensors never launch a CUDA kernel.
    assert (diag_quadratic.launches, smallk_viterbi.launches) == launches


@pytest.mark.parametrize("cov_type,learnable", CASES)
def test_model_info_and_transitions_match_jax(cov_type, learnable):
    jl, tl = _pair(cov_type, learnable)
    t_info = tl.get_model_info()
    j_total = sum(x.size for x in jax.tree.leaves(nnx.state(jl, nnx.Param)))
    assert t_info["total_parameters"] == j_total
    if learnable:
        # The JAX layer's get_model_info raises when it holds the fixed
        # transition buffer (nnx.split without a remainder filter).
        assert t_info == jl.get_model_info()
    np.testing.assert_allclose(tl.get_transition_matrix().detach().numpy(),
                               np.asarray(jl.get_transition_matrix()), atol=1e-6)
    np.testing.assert_allclose(tl._log_a().detach().numpy(),
                               np.asarray(jl._log_a()), atol=1e-6)


def test_fixed_topology_matches_jax_without_bridge():
    jl = JaxLayer(S, D, num_components=C, learnable_transitions=False, rngs=nnx.Rngs(0))
    tl = MixtureGaussianHMMLayer(S, D, num_components=C, learnable_transitions=False,
                                 device="cpu")
    np.testing.assert_array_equal(tl.transition_matrix.numpy(),
                                  np.asarray(jl.transition_matrix[...]))
    assert "transition_matrix" in dict(tl.named_buffers())
    assert "transition_matrix" not in dict(tl.named_parameters())


def test_generator_seeds_initialisation():
    def make(seed):
        return MixtureGaussianHMMLayer(S, D, C, generator=torch.Generator().manual_seed(seed),
                                       device="cpu")

    a, b, c = make(1), make(1), make(2)
    assert torch.equal(a.means, b.means) and not torch.equal(a.means, c.means)


def test_unported_and_unknown_covariances_raise():
    """Full covariance, once refused, builds as the JAX layer does (unit
    initial variances through the softplus diagonal) and decodes as it
    does; an unknown covariance type still raises."""
    jl, tl = _pair("full", True)
    np.testing.assert_array_equal(
        MixtureGaussianHMMLayer(S, D, C, covariance_type="full", device="cpu").cov_params
        .detach().numpy(), np.asarray(jl.cov_params[...]))
    x = np.random.default_rng(5).normal(size=(B, T, D)).astype(np.float32)
    _same_decode(tl(torch.from_numpy(x), return_log_probs=True),
                 jl(jnp.asarray(x), return_log_probs=True))
    with pytest.raises(ValueError, match="Unknown covariance_type"):
        MixtureGaussianHMMLayer(S, D, C, covariance_type="banded", device="cpu")


def test_bridge_rejects_unknown_or_missing_weights():
    jl, _ = _pair("diag", True)
    params = _jax_params(jl)
    with pytest.raises(KeyError, match="not a MixtureGaussianHMMLayer weight"):
        bridge.mixture_gaussian_state_dict({**params, "bias": np.zeros(3)})
    with pytest.raises(KeyError, match="missing"):
        bridge.mixture_gaussian_state_dict({k: v for k, v in params.items() if k != "means"})
    with pytest.raises(KeyError, match="exactly one"):
        bridge.mixture_gaussian_state_dict({**params, "transition_matrix": np.eye(S)})
