"""The port's public signatures against the JAX package's, and the
keywords they carry: ``compute_dtype`` and ``time_chunk`` of the emission
scorers, ``log_vars=`` of ``ops.auto_gmm_viterbi``, ``unroll`` of
``core.viterbi_blocked``, ``batch`` of ``ops.smallk_supported`` and
``precision.mxu_einsum``.

Signatures: every public function of ``emissions``, ``ops``, ``core``
(with its submodules) and ``precision`` in the JAX package has a
counterpart of the same name in the port whose parameters come in the
same order and kind, with a default wherever the JAX one has one, and the
same default where it is a plain literal. Excluded: the framework renames
(``key`` → ``generator``, ``axis`` → ``dim``, ``keepdims`` → ``keepdim``,
an added ``device``), the ``ops`` tiling parameters (``t_chunk``,
``b_tile``, ``precision``), and the two functions the port does not
carry (``ops.pallas_available``, the TPU backend check, and
``precision.matmul_precision``, a ``jax.lax.Precision`` for flax layers).

Parity with ``compute_dtype=bfloat16``: the port's scores against the JAX
package's on the same numpy inputs within 1e-4 + 1e-5 relative (both
round the same operands to bf16 and sum in float32; they were measured
within 3.2e-7 relative of each other, while rounding the scores instead
of the operands is off by up to 0.2%), and against the port's own
float32 scores within 0.5 nats, the bound of
``tests/test_precision.py``'s bf16 parity tests; float32 out. ``compute_dtype=None`` and ``float32`` give
the default path's scores bit for bit.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_hmm_tpu as jph
from pytorch_hmm_tpu import emissions as jem
from pytorch_hmm_tpu import precision as jprec
from pytorch_hmm_tpu_torch import core, emissions, ops, precision

MODULES = ("emissions", "ops", "core", "core.semiring", "core.fb", "core.hsmm", "core.sample",
           "core.viterbi", "precision")
RENAMES = {"key": "generator", "axis": "dim", "keepdims": "keepdim"}
TILING = {"t_chunk", "b_tile", "precision"}
NOT_PORTED = {("ops", "pallas_available"), ("precision", "matmul_precision")}
_LITERALS = (bool, int, float, str, type(None))
BF16_ATOL = 0.5      # tests/test_precision.py: bf16 scores within 0.5 nats
BF16_JAX_ATOL, BF16_JAX_RTOL = 1e-4, 1e-5   # port vs JAX package, both bf16


def _public(mod: str):
    """``(mod, name)`` of every public function of the JAX module: its
    ``__all__`` and the functions it defines without a leading
    underscore."""
    m = importlib.import_module(f"pytorch_hmm_tpu.{mod}")
    names = set(getattr(m, "__all__", ()))
    names |= {n for n, f in vars(m).items()
              if not n.startswith("_") and getattr(f, "__module__", None) == m.__name__}
    out = []
    for n in sorted(names):
        f = getattr(m, n, None)
        if callable(f) and not inspect.isclass(f) and not inspect.ismodule(f):
            out.append((mod, n))
    return out


FUNCTIONS = [fn for mod in MODULES for fn in _public(mod)]


def _params(fn, skip, jax_side):
    out = []
    for p in inspect.signature(fn).parameters.values():
        if p.name in skip:
            continue
        name = RENAMES.get(p.name, p.name) if jax_side else p.name
        renamed = p.name in RENAMES or name in RENAMES.values()
        out.append((name, p.kind, p.default, renamed))
    return out


@pytest.mark.parametrize("mod,name", FUNCTIONS, ids=[f"{m}.{n}" for m, n in FUNCTIONS])
def test_signature_matches_jax(mod, name):
    port = importlib.import_module(f"pytorch_hmm_tpu_torch.{mod}")
    if (mod.split(".")[0], name) in NOT_PORTED:
        assert not hasattr(port, name), f"{mod}.{name} is listed as not ported"
        return
    assert hasattr(port, name), f"the port lacks {mod}.{name}"
    ref = getattr(importlib.import_module(f"pytorch_hmm_tpu.{mod}"), name)
    tiling = TILING if mod == "ops" else set()
    want = _params(ref, tiling, jax_side=True)
    got = _params(getattr(port, name), tiling | ({"device"} - {p[0] for p in want}), jax_side=False)
    assert [(n, k) for n, k, _, _ in got] == [(n, k) for n, k, _, _ in want], (
        f"{mod}.{name}: port {inspect.signature(getattr(port, name))} vs JAX {inspect.signature(ref)}")
    for (n, _, d_got, renamed), (_, _, d_want, _) in zip(got, want):
        if d_want is inspect.Parameter.empty:
            continue
        assert d_got is not inspect.Parameter.empty, f"{mod}.{name}: {n} needs a default"
        if not renamed and isinstance(d_want, _LITERALS):
            assert d_got == d_want, f"{mod}.{name}: {n} defaults to {d_got!r}, JAX {d_want!r}"


# -- compute_dtype --------------------------------------------------------------


def _gmm_problem(cov, S=4, C=2, D=16, B=2, T=24, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, T, D)).astype(np.float32)
    means = rng.normal(size=(S, C, D)).astype(np.float32)
    logits = rng.normal(size=(S, C)).astype(np.float32)
    if cov == "diag":
        cp = (0.3 * rng.normal(size=(S, C, D))).astype(np.float32)
    elif cov == "tied":
        cp = (0.3 * rng.normal(size=(D,))).astype(np.float32)
    elif cov == "spherical":
        cp = (0.3 * rng.normal(size=(S, C))).astype(np.float32)
    else:
        cp = (0.2 * rng.normal(size=(S, C, D * (D + 1) // 2))).astype(np.float32)
    return obs, means, cp, logits


def _full_problem(K=4, D=8, B=2, T=40, seed=2):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, T, D)).astype(np.float32)
    means = rng.normal(size=(K, D)).astype(np.float32)
    a = rng.normal(size=(K, D, D)) * 0.2
    chol = np.linalg.cholesky(np.einsum("kde,kfe->kdf", a, a) + np.eye(D)).astype(np.float32)
    return obs, means, chol


def _scorers():
    """``{name: (jax_fn, port_fn, numpy inputs)}``, each fn taking
    ``compute_dtype`` (the framework's bf16 or float32, or None) and
    returning its scores."""
    out = {}
    for cov in ("diag", "tied", "spherical", "full"):
        a = _gmm_problem(cov)
        out[f"gmm_log_probs {cov}"] = (
            lambda dt, a=a, cov=cov: jem.gmm_log_probs(*map(jnp.asarray, a), cov, compute_dtype=dt),
            lambda dt, a=a, cov=cov: emissions.gmm_log_probs(*map(torch.from_numpy, a), cov, compute_dtype=dt))
        out[f"gmm_component_log_probs {cov}"] = (
            lambda dt, a=a, cov=cov: jem.gmm_component_log_probs(*map(jnp.asarray, a[:3]), cov,
                                                                 compute_dtype=dt),
            lambda dt, a=a, cov=cov: emissions.gmm_component_log_probs(*map(torch.from_numpy, a[:3]), cov,
                                                                       compute_dtype=dt))
    obs, means, chol = _full_problem()
    rng = np.random.default_rng(3)
    lv = (0.3 * rng.normal(size=means.shape)).astype(np.float32)
    ls = (0.2 * rng.normal(size=(means.shape[0], 1))).astype(np.float32)
    raw = (0.1 * rng.normal(size=chol.shape)).astype(np.float32)
    J = lambda *xs: [jnp.asarray(x) for x in xs]          # noqa: E731
    P = lambda *xs: [torch.from_numpy(x) for x in xs]     # noqa: E731
    out["diag_gaussian_log_probs"] = (
        lambda dt: jem.diag_gaussian_log_probs(*J(obs, means, lv), dt),
        lambda dt: emissions.diag_gaussian_log_probs(*P(obs, means, lv), dt))
    out["spherical_gaussian_log_probs"] = (
        lambda dt: jem.spherical_gaussian_log_probs(*J(obs, means, lv[:, 0]), dt),
        lambda dt: emissions.spherical_gaussian_log_probs(*P(obs, means, lv[:, 0]), dt))
    out["full_gaussian_log_probs"] = (
        lambda dt: jem.full_gaussian_log_probs(*J(obs, means, chol), compute_dtype=dt),
        lambda dt: emissions.full_gaussian_log_probs(*P(obs, means, chol), compute_dtype=dt))
    out["full_gaussian_log_probs_prepared"] = (
        lambda dt: jem.full_gaussian_log_probs_prepared(
            jnp.asarray(obs), jem.fullcov_prepare(*J(means, chol)), 16, dt),
        lambda dt: emissions.full_gaussian_log_probs_prepared(
            torch.from_numpy(obs), emissions.fullcov_prepare(*P(means, chol)), 16, dt))
    out["fullcov_mixture_log_probs_prepared"] = (
        lambda dt: jem.fullcov_mixture_log_probs_prepared(
            jnp.asarray(obs), jem.fullcov_prepare(*J(means, chol)), 2, 2, 16, dt),
        lambda dt: emissions.fullcov_mixture_log_probs_prepared(
            torch.from_numpy(obs), emissions.fullcov_prepare(*P(means, chol)), 2, 2, 16, dt))
    for cov, scales in (("diag", lv / 2), ("spherical", ls), ("full", raw)):
        out[f"gaussian_log_probs {cov}"] = (
            lambda dt, s=scales, cov=cov: jem.gaussian_log_probs(*J(obs, means, s), cov, dt),
            lambda dt, s=scales, cov=cov: emissions.gaussian_log_probs(*P(obs, means, s), cov, dt))
    return out


SCORERS = sorted(_scorers())


@pytest.mark.parametrize("name", SCORERS)
def test_bf16_scores_match_jax(name):
    jfn, tfn = _scorers()[name]
    got = tfn(torch.bfloat16)
    assert got.dtype == torch.float32
    want = np.asarray(jfn(jnp.bfloat16))
    exact = tfn(torch.float32).numpy()
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_JAX_ATOL, rtol=BF16_JAX_RTOL, err_msg=name)
    np.testing.assert_allclose(got.numpy(), exact, atol=BF16_ATOL, rtol=0, err_msg=name)
    # The bf16 rounding is there: the scores differ from float32.
    assert not np.array_equal(got.numpy(), exact)


@pytest.mark.parametrize("name", SCORERS)
def test_float32_compute_dtype_is_the_default_path(name):
    _, tfn = _scorers()[name]
    default = tfn(None)
    assert torch.equal(tfn(torch.float32), default)


def test_bf16_viterbi_paths_agree_with_float32():
    """tests/test_precision.py's well-separated decode: bf16 scoring
    flips no frame there, and agrees with the JAX package's bf16 paths."""
    rng = np.random.default_rng(1)
    S, D, B, T = 5, 16, 3, 64
    means = (rng.normal(size=(S, 1, D)) * 4.0).astype(np.float32)
    log_vars = np.zeros((S, 1, D), np.float32)
    logits = np.zeros((S, 1), np.float32)
    states = rng.integers(0, S, size=(B, T))
    obs = (means[states, 0] + rng.normal(size=(B, T, D)) * 0.5).astype(np.float32)
    la = np.full((S, S), np.log(1.0 / S), np.float32)
    lp = np.full((S,), np.log(1.0 / S), np.float32)
    args = [torch.from_numpy(x) for x in (obs, means, log_vars, logits)]
    p32, _ = core.viterbi(emissions.gmm_log_probs(*args, "diag"), torch.from_numpy(la), torch.from_numpy(lp))
    p16, _ = core.viterbi(emissions.gmm_log_probs(*args, "diag", compute_dtype=torch.bfloat16),
                          torch.from_numpy(la), torch.from_numpy(lp))
    assert (p32 == p16).float().mean().item() >= 0.99
    j16 = jem.gmm_log_probs(*map(jnp.asarray, (obs, means, log_vars, logits)), "diag",
                            compute_dtype=jnp.bfloat16)
    jp16, _ = jph.core.viterbi(j16, jnp.asarray(la), jnp.asarray(lp))
    np.testing.assert_array_equal(p16.numpy(), np.asarray(jp16))


def test_bf16_scores_differentiate():
    a = [torch.from_numpy(x) for x in _gmm_problem("diag")]
    means = a[1].clone().requires_grad_(True)
    emissions.gmm_log_probs(a[0], means, a[2], a[3], "diag", compute_dtype=torch.bfloat16).sum().backward()
    assert means.grad is not None and bool(torch.isfinite(means.grad).all())


@pytest.mark.parametrize("time_chunk", [7, 16, 128])
def test_time_chunk_reaches_the_full_scorer(time_chunk):
    a = _gmm_problem("full", T=40)
    got = emissions.gmm_log_probs(*map(torch.from_numpy, a), "full", time_chunk=time_chunk)
    want = jem.gmm_log_probs(*map(jnp.asarray, a), "full", time_chunk=time_chunk)
    whole = emissions.gmm_log_probs(*map(torch.from_numpy, a), "full", time_chunk=1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5, rtol=0)
    comp = emissions.gmm_component_log_probs(*map(torch.from_numpy, a[:3]), "full", time_chunk)
    assert comp.shape == (2, 40, 4, 2)


# -- the other keywords -----------------------------------------------------------


def test_auto_gmm_viterbi_log_vars_alias():
    obs, means, lv, logits = _gmm_problem("diag", S=6, C=2, D=8, B=3, T=30, seed=4)
    rng = np.random.default_rng(5)
    la = np.log(rng.dirichlet(np.ones(6), size=6)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(6))).astype(np.float32)
    log_w = torch.log_softmax(torch.from_numpy(logits), -1)
    t = [torch.from_numpy(x) for x in (obs, means, lv, la, lp)]
    by_alias = ops.auto_gmm_viterbi(t[0], t[1], log_vars=t[2], log_w=log_w, log_a=t[3], log_pi=t[4])
    by_name = ops.auto_gmm_viterbi(t[0], t[1], t[2], log_w, t[3], t[4])
    assert torch.equal(by_alias[0], by_name[0]) and torch.equal(by_alias[1], by_name[1])
    jw = jax.nn.log_softmax(jnp.asarray(logits), -1)
    js, jsc = jph.ops.auto_gmm_viterbi(jnp.asarray(obs), jnp.asarray(means), log_vars=jnp.asarray(lv),
                                       log_w=jw, log_a=jnp.asarray(la), log_pi=jnp.asarray(lp))
    np.testing.assert_array_equal(by_alias[0].numpy(), np.asarray(js))
    np.testing.assert_allclose(by_alias[1].numpy(), np.asarray(jsc), atol=1e-3, rtol=1e-5)


def test_viterbi_blocked_takes_unroll():
    rng = np.random.default_rng(6)
    lo = torch.from_numpy(rng.normal(size=(2, 50, 5)).astype(np.float32))
    la = torch.log_softmax(torch.from_numpy(rng.normal(size=(5, 5)).astype(np.float32)), -1)
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)), -1)
    want = core.viterbi_blocked(lo, la, lp, 4)
    for got in (core.viterbi_blocked(lo, la, lp, 4, 2), core.viterbi_blocked(lo, la, lp, blocks=4, unroll=16)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_smallk_supported_takes_batch():
    assert ops.smallk_supported(12, 32) == ops.smallk_supported(12) is True
    assert ops.smallk_supported(33, 32) is False


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
def test_mxu_einsum_matches_jax(dtype):
    rng = np.random.default_rng(7)
    a = rng.normal(size=(3, 5, 24)).astype(np.float32)
    b = rng.normal(size=(6, 24)).astype(np.float32)
    tdt = None if dtype is None else getattr(torch, dtype)
    jdt = None if dtype is None else getattr(jnp, dtype)
    got = precision.mxu_einsum("bte,ke->btk", torch.from_numpy(a), torch.from_numpy(b), dtype=tdt)
    want = np.asarray(jprec.mxu_einsum("bte,ke->btk", jnp.asarray(a), jnp.asarray(b), dtype=jdt))
    assert got.dtype == torch.float32
    # Products of bf16 values are exact in float32 on both sides; only the
    # order of the float32 sums differs.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    rounded = np.einsum("bte,ke->btk", *(torch.from_numpy(x).to(torch.bfloat16).double().numpy() for x in (a, b)))
    exact = np.einsum("bte,ke->btk", a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), rounded if dtype == "bfloat16" else exact, atol=1e-5, rtol=1e-5)


def test_mxu_einsum_keeps_float64():
    x = torch.randn(4, 3, dtype=torch.float64)
    assert precision.mxu_einsum("ij,kj->ik", x, x).dtype == torch.float64
