"""Full-covariance Gaussian emissions of the torch port against
``pytorch_hmm_tpu.emissions`` on the same numpy inputs, and the two
layers that use them, ``GaussianHMMLayer(covariance_type="full")`` and
``MixtureGaussianHMMLayer(covariance_type="full")``, against their JAX
twins with the weights carried across by ``bridge``, on the CPU.

Both sides run true f32 (JAX on the CPU resolves its products to
``Precision.HIGHEST``; torch's TF32 switches touch only CUDA). The
inverse Cholesky factors differ in method (the JAX package's Newton
iteration, the port's triangular solve), so every table and score is
compared with a stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_hmm_tpu import emissions as je
from pytorch_hmm_tpu.models import GaussianHMMLayer as JaxGaussian
from pytorch_hmm_tpu.models import MixtureGaussianHMMLayer as JaxGMM
from pytorch_hmm_tpu_torch import GaussianHMMLayer, MixtureGaussianHMMLayer, bridge
from pytorch_hmm_tpu_torch import emissions as te

# T=130 is not a multiple of the 128-frame time chunk, so the tail runs.
B, T, K, D = 2, 130, 6, 13


def _flat(state) -> dict:
    return {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(state)}


def _cov_flat(rng, n, d, scale=0.3):
    """Flattened Cholesky parameters near the layers' initialisation:
    0.5413 (unit variance) on the diagonal slots, noise everywhere."""
    flat = scale * rng.normal(size=(n, te.flat_dim(d)))
    flat[:, [i * (i + 1) // 2 + i for i in range(d)]] += 0.5413
    return flat.astype(np.float32)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    obs = (2.0 * rng.normal(size=(B, T, D)) + 3.0).astype(np.float32)
    means = (rng.normal(size=(K, D)) + 3.0).astype(np.float32)
    return obs, means, _cov_flat(rng, K, D)


def test_flat_dim_and_tril_from_flat_match_jax():
    """The gather-built factor: exact lower triangle, softplus + 1e-4
    diagonal within 1e-6."""
    _, _, flat = _inputs()
    assert te.flat_dim(D) == je.flat_dim(D) == D * (D + 1) // 2
    got = te.tril_from_flat(torch.from_numpy(flat), D)
    want = np.asarray(je.tril_from_flat(jnp.asarray(flat), D))
    assert got.shape == (K, D, D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert not torch.triu(got, diagonal=1).any()


@pytest.mark.parametrize("n,d", [(K, D), (48, 80)])
def test_tril_inverse_matches_jax(n, d):
    """At the GMM configuration's (48, 80, 80) too: lower triangular,
    and within 2e-6 of the JAX Newton iteration (entries up to ~2; a
    float64 inverse sits 2.4e-7 from the port's and 1e-7 from JAX's)."""
    flat = _cov_flat(np.random.default_rng(d), n, d, scale=0.1)
    L = te.tril_from_flat(torch.from_numpy(flat), d)
    got = te.tril_inverse(L)
    want = np.asarray(je.tril_inverse(je.tril_from_flat(jnp.asarray(flat), d)))
    assert not torch.triu(got, diagonal=1).any()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    eye = torch.eye(d).expand(n, d, d)
    np.testing.assert_allclose((got @ L).numpy(), eye.numpy(), atol=2e-6)


def test_fullcov_prepare_matches_jax():
    """Every table within rtol 2e-6 of the largest entry of its JAX twin
    (precisions up to ~25, means' quadratic forms up to ~200)."""
    obs, means, flat = _inputs()
    got = te.fullcov_prepare(torch.from_numpy(means), te.tril_from_flat(torch.from_numpy(flat), D))
    want = je.fullcov_prepare(jnp.asarray(means), je.tril_from_flat(jnp.asarray(flat), D))
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].numpy(), w, atol=2e-6 * np.abs(w).max(),
                                   err_msg=name)


def _scores_close(got, want):
    """Scores reach ~1.5e3 here: atol 1e-4 plus rtol 1e-6."""
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("time_chunk", [128, 1000])
def test_full_gaussian_log_probs_match_jax(time_chunk):
    """Chunked (with a 2-frame tail) and in one piece; the prepared form
    equals the composed one exactly."""
    obs, means, flat = _inputs(1)
    tobs, tmeans = torch.from_numpy(obs), torch.from_numpy(means)
    chol_t = te.tril_from_flat(torch.from_numpy(flat), D)
    chol_j = je.tril_from_flat(jnp.asarray(flat), D)
    got = te.full_gaussian_log_probs(tobs, tmeans, chol_t, time_chunk=time_chunk)
    _scores_close(got, je.full_gaussian_log_probs(jnp.asarray(obs), jnp.asarray(means), chol_j,
                                                  time_chunk=time_chunk))
    prepared = te.full_gaussian_log_probs_prepared(tobs, te.fullcov_prepare(tmeans, chol_t),
                                                   time_chunk=time_chunk)
    assert torch.equal(prepared, got)


def test_fullcov_mixture_log_probs_prepared_matches_jax():
    """States S=2 of C=3 components each, the log weights folded into
    ``log_norm``: the in-chunk logsumexp against the JAX function."""
    obs, means, flat = _inputs(2)
    log_w = np.log(np.random.default_rng(2).dirichlet(np.ones(3), size=2)).astype(np.float32)
    prep_t = te.fullcov_prepare(torch.from_numpy(means),
                                te.tril_from_flat(torch.from_numpy(flat), D))
    prep_t["log_norm"] = prep_t["log_norm"] + torch.from_numpy(log_w).reshape(-1)
    prep_j = je.fullcov_prepare(jnp.asarray(means), je.tril_from_flat(jnp.asarray(flat), D))
    prep_j = dict(prep_j, log_norm=prep_j["log_norm"] + jnp.asarray(log_w).reshape(-1))
    got = te.fullcov_mixture_log_probs_prepared(torch.from_numpy(obs), prep_t, 2, 3)
    assert got.shape == (B, T, 2)
    _scores_close(got, je.fullcov_mixture_log_probs_prepared(jnp.asarray(obs), prep_j, 2, 3))


def test_gaussian_log_probs_full_matches_jax_with_gradients():
    """``GaussianHMMLayer``'s parameterization (strict lower triangle plus
    exp of the diagonal of raw ``(K, D, D)`` log-scales; the upper
    triangle is unused and gets no gradient): scores, and the gradients
    of their sum within rtol 1e-5 of each tensor's largest entry."""
    obs, means, _ = _inputs(3)
    ls = (0.2 * np.random.default_rng(3).normal(size=(K, D, D))).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (means, ls)]
    got = te.gaussian_log_probs(torch.from_numpy(obs), *args, "full")
    got.sum().backward()
    want, want_g = jax.value_and_grad(
        lambda m, s: jnp.sum(je.gaussian_log_probs(jnp.asarray(obs), m, s, "full")),
        argnums=(0, 1))(jnp.asarray(means), jnp.asarray(ls))
    np.testing.assert_allclose(got.sum().item(), float(want), rtol=1e-6)
    _scores_close(got.detach(), je.gaussian_log_probs(jnp.asarray(obs), jnp.asarray(means),
                                                      jnp.asarray(ls), "full"))
    for a, w in zip(args, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(a.grad.numpy(), w, atol=1e-5 * np.abs(w).max())
    assert not torch.triu(args[1].grad, diagonal=1).any()


# -- GaussianHMMLayer(covariance_type="full") --------------------------------------


def test_gaussian_layer_full_matches_jax():
    """``GaussianHMMLayer(40, 8, "full")`` at T=1030 (both sides' plain
    scans on the CPU; on the card this shape takes the prob-space
    kernels): train-mode posteriors within atol 2e-3 (raw alpha + beta
    reach ~1e4 here, where one f32 ulp is ~1e-3, and neither side shifts
    its emissions on the CPU), the loss within rtol 1e-5, every gradient
    within 3e-5 of each tensor's largest entry, eval-mode one-hot
    alignments identical. Both sides differentiate a max-shifted
    logsumexp whose weights sum to 1 at |log Z| ~ 9e3; on these inputs
    the gradients sit at most 4.2e-6 of each tensor's max apart
    (``log_scales``)."""
    Kg, Dg, Tg = 40, 8, 1030
    jl = JaxGaussian(Kg, Dg, covariance_type="full", rngs=nnx.Rngs(0))
    rng = np.random.default_rng(40)
    jl.log_scales[...] = jnp.asarray(0.1 * rng.normal(size=(Kg, Dg, Dg)), jnp.float32)
    tl = GaussianHMMLayer(Kg, Dg, covariance_type="full", device="cpu")
    assert tl.log_scales.shape == (Kg, Dg, Dg)
    tl.load_state_dict(bridge.gaussian_hmm_layer_state_dict(_flat(nnx.state(jl))))
    means = np.asarray(jl.means[...])
    states = np.minimum(np.arange(Tg)[None, :] // rng.integers(20, 30, size=(2, 1)), Kg - 1)
    x = (means[states] + 0.5 * rng.normal(size=(2, Tg, Dg))).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(tl(xt).detach().numpy(), np.asarray(jl(xj)), atol=2e-3)
    want_v, want_g = nnx.value_and_grad(lambda m: m.compute_loss(xj))(jl)
    loss = tl.compute_loss(xt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    want_g = _flat(want_g)
    for name, p in tl.named_parameters():
        w = want_g[name]
        np.testing.assert_allclose(p.grad.numpy(), w, atol=3e-5 * np.abs(w).max(), err_msg=name)
    jl.eval()
    tl.eval()
    np.testing.assert_array_equal(tl(xt).numpy(), np.asarray(jl(xj)))
    assert set(bridge.gaussian_hmm_layer_numpy(tl)) == set(_flat(nnx.state(jl)))


# -- MixtureGaussianHMMLayer(covariance_type="full") -------------------------------

S, C, Dm, Bm, Tm = 5, 3, 6, 3, 60
LENGTHS = [60, 17, 1]


def _gmm_pair(learnable=True):
    jl = JaxGMM(S, Dm, num_components=C, covariance_type="full",
                learnable_transitions=learnable, rngs=nnx.Rngs(0))
    rng = np.random.default_rng(7)
    jl.cov_params[...] = jl.cov_params[...] + jnp.asarray(
        0.2 * rng.normal(size=jl.cov_params.shape), jnp.float32)
    names = ["mixture_weights_logits", "means", "cov_params",
             "transition_logits" if learnable else "transition_matrix"]
    tl = MixtureGaussianHMMLayer(S, Dm, num_components=C, covariance_type="full",
                                 learnable_transitions=learnable, device="cpu")
    tl.load_state_dict(bridge.mixture_gaussian_state_dict(
        {n: np.asarray(getattr(jl, n)[...]) for n in names}))
    return jl, tl


@pytest.fixture(scope="module")
def gmm_obs():
    """Segments of a walk over S centres, so EM has something to find."""
    rng = np.random.default_rng(0)
    centers = 2.0 * rng.normal(size=(S, Dm))
    states = (np.arange(Tm)[None, :] // rng.integers(5, 15, size=(Bm, 1))) % S
    return (centers[states] + rng.normal(size=(Bm, Tm, Dm))).astype(np.float32)


def test_gmm_full_initialisation_matches_jax():
    """Unit initial variances: 0.5413 on the diagonal slots of ``(S, C,
    D(D+1)/2)`` zeros, as the JAX layer; ``get_model_info`` counts the
    same parameters."""
    jl = JaxGMM(S, Dm, num_components=C, covariance_type="full", rngs=nnx.Rngs(0))
    tl = MixtureGaussianHMMLayer(S, Dm, num_components=C, covariance_type="full", device="cpu")
    np.testing.assert_array_equal(tl.cov_params.detach().numpy(), np.asarray(jl.cov_params[...]))
    assert tl.get_model_info() == jl.get_model_info()


@pytest.mark.parametrize("learnable", [True, False])
def test_gmm_full_decode_and_decoder_match_jax(gmm_obs, learnable):
    """Decode paths identical, unragged and ragged; scores within rtol
    1e-5, atol 1e-3. The prepared full-covariance decoder (weights folded
    into the normalizer, logsumexp inside each time chunk) gives the live
    path's states and scores within 1e-4, and JAX's decoder's; its tables
    hold no autograd graph and keep their values when the parameters
    change."""
    jl, tl = _gmm_pair(learnable)
    tl.eval()
    o_j, o_t = jnp.asarray(gmm_obs), torch.from_numpy(gmm_obs)
    len_j, len_t = jnp.asarray(LENGTHS, jnp.int32), torch.tensor(LENGTHS)
    for got, want in ((tl(o_t, True), jl(o_j, True)),
                      (tl(o_t, True, len_t), jl(o_j, True, len_j))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-3)
    dec = tl.make_decoder()
    assert set(dec.emission_tables) == {"prec", "pm", "mm", "center", "log_norm"}
    assert not any(t.requires_grad for t in dec.emission_tables.values())
    for ln_t, ln_j in ((None, None), (len_t, len_j)):
        live = tl(o_t, True, ln_t)
        got = dec(o_t, True, ln_t)
        want = jl.make_decoder()(o_j, True, ln_j)
        np.testing.assert_array_equal(got[0].numpy(), live[0].numpy())
        np.testing.assert_allclose(got[1].numpy(), live[1].numpy(), atol=1e-4)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dec.log_obs(o_t).numpy(),
                               tl.get_observation_log_probs(o_t).detach().numpy(), atol=1e-4)
    frozen = {k: t.clone() for k, t in dec.emission_tables.items()}
    with torch.no_grad():
        tl.means.add_(1.0)
        tl.cov_params.mul_(2.0)
    for k, t in dec.emission_tables.items():
        assert torch.equal(t, frozen[k]), k


@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_gmm_full_loss_gradients_match_jax(gmm_obs, lengths):
    """Loss within rtol 1e-5; every gradient within 2e-4 of each tensor's
    largest entry: the port's CPU path (autograd through the f32
    logsumexp steps of ``core.log_likelihood``) sits up to 1.2e-4 of each
    tensor's max off float64 on these inputs, JAX's scan 1.5e-5."""
    jl, tl = _gmm_pair()
    len_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    len_t = None if lengths is None else torch.tensor(lengths)
    want_v, want_g = nnx.value_and_grad(lambda m: m.compute_loss(jnp.asarray(gmm_obs), len_j))(jl)
    loss = tl.compute_loss(torch.from_numpy(gmm_obs), len_t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    for name, p in tl.named_parameters():
        w = np.asarray(want_g[name][...])
        np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-4 * np.abs(w).max(), err_msg=name)


def test_gmm_full_em_step_matches_jax(gmm_obs):
    """One Baum-Welch step with the full scatter matrix and its Cholesky
    factor: the mean log-likelihood within rtol 1e-5, every updated
    parameter within atol 2e-4 (the Cholesky parameters of f32 scatter
    matrices, and the inverse softplus written overflow-free); logits as
    probabilities. Five steps never lower the likelihood."""
    jl, tl = _gmm_pair()
    want_ll = jl.em_step(jnp.asarray(gmm_obs))
    got_ll = tl.em_step(torch.from_numpy(gmm_obs))
    np.testing.assert_allclose(got_ll.item(), float(want_ll), rtol=1e-5)
    for name, value in bridge.mixture_gaussian_numpy(tl).items():
        want = np.asarray(getattr(jl, name)[...])
        if name.endswith("_logits"):
            value, want = (np.asarray(jax.nn.softmax(v, -1)) for v in (value, want))
        np.testing.assert_allclose(value, want, atol=2e-4, err_msg=name)
    x = torch.from_numpy(gmm_obs)
    lls = [tl.em_step(x).item() for _ in range(5)]
    assert all(b >= a - 1e-3 for a, b in zip(lls, lls[1:])), lls
