"""The training slice: the likelihood's autograd Functions, ``compute_loss``
gradients and Baum-Welch ``em_step`` of the torch port vs the JAX
package, on the same numpy inputs and the same weights (carried across
with ``bridge``).

Both sides run true f32 on the CPU (the JAX emissions take their
``Precision.HIGHEST`` f32 path off the TPU; torch's TF32 switches touch
only CUDA products, which these tests do not run). The Functions' CPU path is
the plain sum recursions, so their closed-form backward is the code the
card runs. Tolerances, each with its reason, are at the asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_hmm_tpu import core as jcore
from pytorch_hmm_tpu import ops as jops
from pytorch_hmm_tpu.models import MixtureGaussianHMMLayer as JaxLayer
from pytorch_hmm_tpu_torch import MixtureGaussianHMMLayer, bridge, core, ops, precision

S, C, D = 4, 2, 5
B, T = 3, 40
LENGTHS = [40, 17, 1]


def _problem(B, T, K, seed):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(B, T, K)).astype(np.float32)
    la = np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    return lo, la, lp


def _torch_value_and_grads(fn, arrays, *extra):
    args = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    val = fn(*args, *extra)
    val.sum().backward()
    return val.detach().numpy(), [a.grad.numpy() for a in args]


@pytest.mark.parametrize("lengths", [None, [90, 60, 17, 1]])
def test_likelihood_functions_match_jax_custom_vjps(lengths):
    """``pallas_log_likelihood`` / ``_pallas_ll_masked`` (the port's
    autograd Functions) against ``jax.value_and_grad`` of the JAX
    custom-VJP functions, their Pallas kernels in interpret mode. atol
    1e-3, as the JAX package holds its own VJPs to its scans
    (tests/test_ops.py)."""
    arrays = _problem(4, 90, 6, seed=9)
    if lengths is None:
        jfn, tfn, extra_j, extra_t = jops.pallas_log_likelihood, ops.pallas_log_likelihood, (), ()
    else:
        jfn, tfn = jops._pallas_ll_masked, ops._pallas_ll_masked
        extra_j = (jnp.asarray(lengths, jnp.int32),)
        extra_t = (torch.tensor(lengths, dtype=torch.int32),)
    want_v, want_g = jax.value_and_grad(
        lambda *a: jnp.sum(jfn(*a, *extra_j)), argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    got_v, got_g = _torch_value_and_grads(tfn, arrays, *extra_t)
    np.testing.assert_allclose(got_v.sum(), np.asarray(want_v), atol=1e-3)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-3)


@pytest.mark.parametrize("lengths", [None, [60, 33, 1]])
def test_functions_agree_with_autograd_through_the_scan(lengths):
    """The closed-form backward (on max-shifted chains) against autograd
    through ``core.log_likelihood`` in float64, on emissions of
    speech-like magnitude: the Functions' own f32 error, atol 1e-4 on
    the posteriors and rtol 1e-4 on the transition gradient, a sum of
    ~T·B of them."""
    lo, la, lp = _problem(3, 60, 5, seed=21)
    lo = 30.0 * lo - 100.0
    ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    fn = ops.pallas_log_likelihood if ln is None else ops._pallas_ll_masked
    got_v, got_g = _torch_value_and_grads(fn, (lo, la, lp), *(() if ln is None else (ln,)))
    want_v, want_g = _torch_value_and_grads(
        lambda *a: core.log_likelihood(*a, ln), [a.astype(np.float64) for a in (lo, la, lp)])
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_auto_log_likelihood_on_cpu_matches_jax():
    arrays = _problem(2, 50, 7, seed=2)
    lens = [50, 23]
    want_v, want_g = jax.value_and_grad(
        lambda *a: jnp.sum(jops.auto_log_likelihood(*a, jnp.asarray(lens, jnp.int32))),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    got_v, got_g = _torch_value_and_grads(ops.auto_log_likelihood, arrays, torch.tensor(lens))
    np.testing.assert_allclose(got_v.sum(), np.asarray(want_v), atol=1e-3)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)


# -- the layer ---------------------------------------------------------------


def _pair(cov_type, learnable=True):
    jl = JaxLayer(S, D, num_components=C, covariance_type=cov_type,
                  learnable_transitions=learnable, rngs=nnx.Rngs(0))
    names = ["mixture_weights_logits", "means", "cov_params",
             "transition_logits" if learnable else "transition_matrix"]
    tl = MixtureGaussianHMMLayer(S, D, num_components=C, covariance_type=cov_type,
                                 learnable_transitions=learnable, device="cpu")
    tl.load_state_dict(bridge.mixture_gaussian_state_dict(
        {n: np.asarray(getattr(jl, n)[...]) for n in names}))
    return jl, tl


@pytest.fixture(scope="module")
def obs():
    """Segments of a walk over S Gaussian centres: EM has something to
    find."""
    rng = np.random.default_rng(0)
    centers = 2.0 * rng.normal(size=(S, D))
    states = (np.arange(T)[None, :] // rng.integers(5, 15, size=(B, 1))) % S
    return (centers[states] + rng.normal(size=(B, T, D))).astype(np.float32)


@pytest.mark.parametrize("cov_type", ["diag", "tied", "spherical"])
@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_compute_loss_and_gradients_match_jax(obs, cov_type, lengths):
    """Loss within rtol 1e-5 (f32 sums of ~T·D terms), every parameter's
    gradient within atol 1e-4, rtol 1e-4 (f32 autograd of two different
    scans: JAX's lax.scan and the port's loop)."""
    jl, tl = _pair(cov_type)
    len_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    len_t = None if lengths is None else torch.tensor(lengths)
    want_v, want_g = nnx.value_and_grad(lambda m: m.compute_loss(jnp.asarray(obs), len_j))(jl)
    loss = tl.compute_loss(torch.from_numpy(obs), len_t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[name][...]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("cov_type,learnable", [("diag", True), ("tied", True),
                                                ("spherical", True), ("diag", False)])
def test_em_step_matches_jax(obs, cov_type, learnable):
    """One Baum-Welch step: the returned mean log-likelihood within rtol
    1e-5, every updated parameter within atol 1e-4 (f32 sufficient
    statistics summed in another order; the port's E-step also runs on
    max-shifted emissions). The mixture and transition logits, which
    are log(p + 1e-10) and all rounding for near-zero p, are compared as
    probabilities."""
    jl, tl = _pair(cov_type, learnable)
    want_ll = jl.em_step(jnp.asarray(obs))
    got_ll = tl.em_step(torch.from_numpy(obs))
    np.testing.assert_allclose(got_ll.item(), float(want_ll), rtol=1e-5)
    got = bridge.mixture_gaussian_numpy(tl)
    for name, value in got.items():
        want = np.asarray(getattr(jl, name)[...])
        if name.endswith("_logits"):
            value, want = (np.asarray(jax.nn.softmax(v, -1)) for v in (value, want))
        np.testing.assert_allclose(value, want, atol=1e-4, err_msg=name)
    assert not any(p.requires_grad and p.grad is not None for p in tl.parameters())


@pytest.mark.parametrize("cov_type", ["diag", "tied", "spherical"])
def test_five_em_steps_never_lower_the_likelihood(obs, cov_type):
    _, tl = _pair(cov_type)
    x = torch.from_numpy(obs)
    lls = [tl.em_step(x).item() for _ in range(5)]
    # EM is monotone in exact arithmetic; allow f32 rounding of ~1e3.
    assert all(b >= a - 1e-3 for a, b in zip(lls, lls[1:])), lls
    assert lls[-1] > lls[0]


def test_em_step_refuses_a_mesh_before_any_work(obs):
    _, tl = _pair("diag")
    before = {k: v.clone() for k, v in tl.state_dict().items()}
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tl.em_step(torch.from_numpy(obs), mesh=object())
    assert all(torch.equal(v, tl.state_dict()[k]) for k, v in before.items())


@pytest.mark.parametrize("fn", ["auto_log_likelihood", "auto_forward", "auto_forward_backward"])
def test_cuda_dispatch_raises_where_no_kernel_exists(fn):
    """Off the CPU every shape with a kernel reaches its wrapper, which
    raises on what it cannot launch instead of falling back (meta
    tensors stand in for CUDA ones): static K=33 the general-K
    ``pallas_forward``, time-varying K <= 32 ``fbsum_smallk``. Shapes no
    kernel of either package takes (time-varying K=33) run the plain
    ``core`` on the tensors' own device."""
    f = getattr(ops, fn)
    with pytest.raises(ValueError, match="pallas_forward runs on CPU or CUDA"):
        f(torch.empty(2, 5, 33, device="meta"), torch.empty(33, 33, device="meta"),
          torch.empty(33, device="meta"))
    with pytest.raises(ValueError, match="fbsum_smallk runs on CPU or CUDA"):
        f(torch.empty(2, 5, 4, device="meta"), torch.empty(2, 5, 4, 4, device="meta"),
          torch.empty(4, device="meta"))
    out = f(torch.empty(2, 5, 33, device="meta"), torch.empty(2, 5, 33, 33, device="meta"),
            torch.empty(33, device="meta"))
    assert all(t.device.type == "meta" for t in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("lengths", [None, [30, 17, 1]])
@pytest.mark.parametrize("neg_inf", [False, True], ids=["dense", "-inf band"])
def test_time_varying_likelihood_function_matches_jax_autodiff(lengths, neg_inf):
    """The time-varying likelihood Function (``fbsum_smallk`` forward,
    closed-form per-frame ξ backward) against ``jax.value_and_grad`` of
    ``core.log_likelihood``: values and gradients in log_obs, the
    ``(B, T, K, K)`` log_a (zero at t = 0 and past each row's end) and
    log_pi. atol 1e-4 (f32 posteriors of 30 frames in another order)."""
    B_, T_, K = 3, 30, 5
    rng = np.random.default_rng(7)
    lo = rng.normal(size=(B_, T_, K)).astype(np.float32)
    logits = rng.normal(size=(B_, T_, K, K))
    if neg_inf:
        i = np.arange(K)
        logits = np.where((i[None, :] >= i[:, None]) & (i[None, :] <= i[:, None] + 1),
                          logits, -np.inf)
    la = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    ln_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want_v, want_g = jax.value_and_grad(
        lambda *a: jnp.sum(jcore.log_likelihood(*a, ln_j)), argnums=(0, 1, 2)
    )(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp))
    ln_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    got_v, got_g = _torch_value_and_grads(ops._pallas_ll_masked, [lo, la, lp], ln_t)
    np.testing.assert_allclose(got_v.sum(), float(want_v), atol=1e-4)
    for g, w in zip(got_g, want_g):
        w = np.where(np.isfinite(w), np.asarray(w), 0.0)
        np.testing.assert_allclose(g, w, atol=1e-4)
    d_la = got_g[1]
    assert np.all(d_la[:, 0] == 0)
    if lengths is not None:
        for b, n in enumerate(lengths):
            assert np.all(d_la[b, n:] == 0)


def test_checkpointing_changes_no_gradient(obs):
    """``maybe_remat`` recomputes the emission scores in the backward
    pass; the gradients are the same with it on and off."""
    grads = []
    for enabled in (True, False):
        precision.set_checkpointing(enabled)
        try:
            _, tl = _pair("diag")
            tl.compute_loss(torch.from_numpy(obs)).backward()
            grads.append([p.grad.clone() for p in tl.parameters()])
        finally:
            precision.set_checkpointing(True)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_numpy_bridge_round_trips(obs):
    jl, tl = _pair("tied", learnable=False)
    out = bridge.mixture_gaussian_numpy(tl)
    assert set(out) == {"mixture_weights_logits", "means", "cov_params", "transition_matrix"}
    back = MixtureGaussianHMMLayer(S, D, num_components=C, covariance_type="tied",
                                   learnable_transitions=False, device="cpu")
    back.load_state_dict(bridge.mixture_gaussian_state_dict(out))
    for k, v in back.state_dict().items():
        assert torch.equal(v, tl.state_dict()[k])
    np.testing.assert_array_equal(out["means"], np.asarray(jl.means[...]))
