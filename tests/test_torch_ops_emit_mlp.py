"""Row 16 of the kernel table, ``fused_gaussian_emission``: the port's
plain version and autograd Function vs the JAX package.

The same numpy inputs go to both; the JAX kernel runs in interpret mode
on the CPU (true f32 dots there), the port's Function runs its plain
version on CPU tensors, which is what the CUDA kernel is held to on the
card. Tolerances: values rtol/atol 1e-4, the JAX package's own for its
kernel against its XLA path (tests/test_neural.py); gradients against
``jax.grad`` of the XLA path rtol 1e-4 and atol 1e-5 of each gradient's
largest entry (f32 sums of up to T·B terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_hmm_tpu.models import NeuralObservationModel as JaxObs
from pytorch_hmm_tpu.ops.emit_mlp import fused_gaussian_emission as jax_fused
from pytorch_hmm_tpu_torch import NeuralObservationModel, bridge
from pytorch_hmm_tpu_torch.ops import emit_mlp

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, T, D, H, S, seed):
    """Observations, weights in the ``(in, out)`` layout and the
    parameter-only tables, as numpy f32."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    obs = w(B, T, D)
    w1, b1 = w(D, H, scale=D ** -0.5), w(H, scale=0.1)
    w2, b2 = w(H, H, scale=H ** -0.5), w(H, scale=0.1)
    wm, bm = w(H, D, scale=H ** -0.5), w(D, scale=0.1)
    wlv, blv = w(H, D, scale=0.3 * H ** -0.5), w(D, scale=0.1)
    emb = w(S, H, scale=H ** -0.5)
    tables = emit_mlp.gaussian_tables(torch.from_numpy(emb), torch.from_numpy(wm),
                                      torch.from_numpy(wlv))
    return [obs, w1, b1, w2, b2, wm, bm, wlv, blv] + [t.numpy() for t in tables]


@pytest.mark.parametrize("B,T,D,H,S", [(2, 18, 6, 64, 5), (2, 50, 80, 256, 12),
                                       (1, 70, 13, 48, 1)])
def test_plain_version_matches_the_jax_kernel(B, T, D, H, S):
    arrays = _inputs(B, T, D, H, S, seed=B * T + D)
    want = jax_fused(*(jnp.asarray(a) for a in arrays),
                     precision=jax.lax.Precision.HIGHEST)
    got = emit_mlp.fused_gaussian_emission(*(torch.from_numpy(a) for a in arrays))
    assert got.shape == (B, T, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The Function on CPU tensors is the plain version, bit for bit.
    ref = emit_mlp.fused_gaussian_emission_reference(*(torch.from_numpy(a) for a in arrays))
    assert torch.equal(got, ref)


def _flat_params(model):
    return {".".join(map(str, p)): np.asarray(v[...])
            for p, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


@pytest.mark.parametrize("D,H,S", [(6, 32, 4), (13, 48, 7)])
def test_function_gradients_match_jax_grad_of_the_xla_path(D, H, S):
    """Eval mode: the port scores every state through the Function (its
    backward recomputes the plain version), the JAX package on the CPU
    through ``_all_state_log_probs``; gradients of a weighted sum of the
    scores with respect to every weight and the observations agree."""
    B, T = 2, 21
    rng = np.random.default_rng(D * H)
    obs = rng.normal(size=(B, T, D)).astype(np.float32)
    cot = rng.normal(size=(B, T, S)).astype(np.float32)
    jm = JaxObs(S, D, hidden_dim=H, rngs=nnx.Rngs(7)).eval()
    tm = NeuralObservationModel(S, D, hidden_dim=H, device="cpu").eval()
    tm.load_state_dict(bridge.neural_observation_state_dict(_flat_params(jm)))

    def jloss(m, x):
        return jnp.sum(m.log_probs(x) * cot)

    gm, gx = nnx.grad(jloss, argnums=(0, 1))(jm, jnp.asarray(obs))
    want = bridge.neural_observation_state_dict(
        {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(gm)
         if ".".join(map(str, p)) in _flat_params(jm)})
    launches = emit_mlp.fused_gaussian_emission.launches
    x = torch.from_numpy(obs).requires_grad_(True)
    (tm.log_probs(x) * torch.from_numpy(cot)).sum().backward()
    assert emit_mlp.fused_gaussian_emission.launches == launches   # no kernel on the CPU
    assert tm._use_fused_emission()
    pairs = [(x.grad, torch.from_numpy(np.array(gx)))]
    pairs += [(p.grad, want[name]) for name, p in tm.named_parameters()]
    for got, exp in pairs:
        scale = float(exp.abs().max())
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-4, atol=1e-5 * scale)


def test_function_gradcheck_in_float64():
    arrays = _inputs(1, 5, 3, 8, 2, seed=3)
    args = [torch.from_numpy(a).double().requires_grad_(True) for a in arrays]
    assert torch.autograd.gradcheck(emit_mlp.fused_gaussian_emission, args, eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def test_envelope_is_shared_memory():
    ok = emit_mlp.fused_emission_supported
    assert ok(80, 256, 12) and ok(80, 256, 1) and ok(80, 256, 128)
    assert ok(13, 48, 7) and ok(80, 352, 128)
    assert not ok(80, 353, 12)          # h1 and h2 tiles no longer fit 227 KB
    assert not ok(0, 256, 12) and not ok(80, 256, 0)
    assert emit_mlp._smem_bytes(80, 256) == 173_568


def test_off_the_cpu_the_wrapper_checks_then_launches_or_raises():
    """Meta tensors stand in for CUDA ones: the shapes are checked, then
    the device, before any kernel work; there is no fallback."""
    arrays = _inputs(1, 4, 6, 32, 3, seed=1)
    meta = [torch.empty(a.shape, device="meta") for a in arrays]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        emit_mlp.fused_gaussian_emission(*meta)
    bad = list(meta)
    bad[1] = torch.empty(5, 32, device="meta")
    with pytest.raises(ValueError, match="w1 must be"):
        emit_mlp.fused_gaussian_emission(*bad)
