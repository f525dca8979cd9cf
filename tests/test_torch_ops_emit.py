"""``diag_quadratic`` port: its plain version vs the JAX Pallas kernel,
the kernel loader's failure modes and the launch seam's marshalling.

The JAX kernel runs in interpret mode at ``Precision.HIGHEST`` (true f32)
on the CPU; torch runs with TF32 off. The CUDA kernel itself is checked
against the same plain version on the card by ``chip_smoke.py``.
"""

import ctypes
import os
import stat
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu.ops.emit import diag_quadratic as jax_diag_quadratic
from pytorch_hmm_tpu_torch.ops import _build
from pytorch_hmm_tpu_torch.ops.emit import diag_quadratic, diag_quadratic_reference


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("B,T,D,N", [(2, 100, 20, 12), (3, 257, 80, 48),
                                     (1, 33, 7, 5)])
def test_reference_matches_jax_kernel(rng, B, T, D, N):
    obs = rng.normal(size=(B, T, D)).astype(np.float32)
    wq = (rng.normal(size=(D, N)) ** 2).astype(np.float32)
    wl = rng.normal(size=(D, N)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    want = jax_diag_quadratic(jnp.asarray(obs), jnp.asarray(wq), jnp.asarray(wl),
                              jnp.asarray(b), precision=jax.lax.Precision.HIGHEST)
    got = diag_quadratic_reference(*(torch.from_numpy(a) for a in (obs, wq, wl, b)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-5)


def test_wrapper_on_cpu_runs_plain_version_without_launching(rng):
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((2, 9, 6), (6, 4), (6, 4), (4,))]
    before = diag_quadratic.launches
    assert torch.equal(diag_quadratic(*args), diag_quadratic_reference(*args))
    assert diag_quadratic.launches == before


def test_wrapper_raises_off_cpu_instead_of_falling_back():
    args = [torch.empty(s, device="meta") for s in ((2, 9, 6), (6, 4), (6, 4), (4,))]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        diag_quadratic(*args)


def _isolated_build_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})


def test_loader_without_nvcc_raises(monkeypatch, tmp_path):
    _isolated_build_dir(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("diag_quadratic", {"diag_quadratic_f32": [ctypes.c_void_p]})
    assert not (tmp_path / "_build").exists()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    _isolated_build_dir(monkeypatch, tmp_path)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build("smallk_viterbi")
    assert os.listdir(tmp_path / "_build") == []


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    a = _build.library_path("diag_quadratic")
    b = _build.library_path("smallk_viterbi")
    assert a.parent == _build.BUILD_DIR and a.name.startswith("libdiag_quadratic-")
    assert a != b
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("diag_quadratic") != a


def test_build_with_defines_is_its_own_library(monkeypatch, tmp_path):
    """A build with macros defined (the prob-space probe) keys its own
    library and passes each macro to nvcc as -D; the plain build stays."""
    _isolated_build_dir(monkeypatch, tmp_path)
    plain = _build.library_path("scan_prob")
    probe = _build.library_path("scan_prob", ("SCAN_PROB_PROBE",))
    assert probe != plain and probe.name.startswith("libscan_prob-")
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "$@" >&2\nexit 2\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="-DSCAN_PROB_PROBE"):
        _build.build("scan_prob", ("SCAN_PROB_PROBE",))


def test_library_launch_marshals_the_abi_and_raises_on_error(monkeypatch):
    """A declared library loads at its first launch, once; each buffer
    goes as its tensor's address or a null pointer, numbers as they are,
    then the first buffer's device index (the current device where there
    is none) and the current stream's handle; a nonzero return raises
    with the code."""
    calls, loads = [], []
    rcs = iter([0, 0, 912])
    record = lambda *args: calls.append(args) or next(rcs)  # noqa: E731
    fake = SimpleNamespace(k_f32=record, probe=record)
    monkeypatch.setattr(_build, "load", lambda *a: loads.append(a) or fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    _P, _I = ctypes.c_void_p, ctypes.c_int
    sigs = {"k_f32": [_P] * 3 + [_I, ctypes.c_float, _I, _P], "probe": [_I] * 3 + [_P]}
    lib = _build.Library("k", sigs, ("K_PROBE",))
    assert loads == []
    x, y = torch.zeros(3), torch.ones(2)
    lib.launch("k_f32", "k", x, None, y, 5, 0.5)
    lib.launch("probe", "probe", 4, 6)
    assert calls == [(x.data_ptr(), None, y.data_ptr(), 5, 0.5, x.device.index, 77), (4, 6, 3, 77)]
    with pytest.raises(_build.LaunchError, match="k kernel launch failed: CUDA error 912") as err:
        lib.launch("k_f32", "k", x, None, y, 6, 1.5)
    assert err.value.rc == 912 and isinstance(err.value, RuntimeError)
    assert loads == [("k", sigs, ("K_PROBE",))]


def _grad_problem(rng, B, T, D, N, dtype=np.float32):
    return [rng.normal(size=s).astype(dtype) for s in ((B, T, D), (D, N), (D, N), (N,), (B, T, N))]


def test_function_backward_passes_gradcheck():
    """The autograd Function's hand-written backward against finite
    differences, in float64 on a tiny shape (the CPU forward is the plain
    version, which keeps float64)."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in _grad_problem(rng, 2, 3, 4, 5, np.float64)[:4]]
    assert torch.autograd.gradcheck(diag_quadratic, args)


def test_function_gradients_match_jax_grad_of_xla_form():
    """Gradients of ``Σ w ⊙ diag_quadratic(...)`` in all four inputs
    against ``jax.grad`` of the XLA form at Precision.HIGHEST (the JAX
    kernel has no VJP; XLA differentiates its plain form). Tolerance of
    the forward test (atol 2e-4, rtol 1e-5)."""
    rng = np.random.default_rng(4)
    obs, wq, wl, b, w = _grad_problem(rng, 2, 50, 20, 12)

    def loss(x, q, lin, bias):
        hi = jax.lax.Precision.HIGHEST
        out = jnp.matmul(x * x, q, precision=hi) + jnp.matmul(x, lin, precision=hi) + bias
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (obs, wq, wl, b)))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (obs, wq, wl, b)]
    (diag_quadratic(*args) * torch.from_numpy(w)).sum().backward()
    for a, g in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("cov", ["diag", "tied"])
def test_emission_gradients_match_jax(cov):
    """Diag and tied GMM scores back-propagate through the Function to
    the observations, means and log-variances as the JAX XLA emission
    does (atol 1e-4, rtol 1e-5)."""
    from pytorch_hmm_tpu.emissions import gmm_component_log_probs as jax_comp
    from pytorch_hmm_tpu_torch.emissions import gmm_component_log_probs

    rng = np.random.default_rng(5)
    S, C, D = 3, 2, 6
    obs = rng.normal(size=(2, 30, D)).astype(np.float32)
    means = rng.normal(size=(S, C, D)).astype(np.float32)
    cov_p = (0.3 * rng.normal(size=(S, C, D) if cov == "diag" else (D,))).astype(np.float32)
    w = rng.normal(size=(2, 30, S, C)).astype(np.float32)

    want = jax.grad(lambda *a: jnp.sum(jax_comp(*a, cov) * jnp.asarray(w)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (obs, means, cov_p)))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (obs, means, cov_p)]
    (gmm_component_log_probs(*args, cov) * torch.from_numpy(w)).sum().backward()
    for a, g in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("D", [1, 7, 16, 77, 80, 128, 200, 256])
def test_column_tile_plan_covers_n_and_fits_shared_memory(D):
    """Row 1's launch plan for N up to 2048: ceil(N / 64) column tiles of
    8·tn columns that cover N with less than one column group of padding
    a tile (N=48: one tile of 48; N=256: four of 64), and at most 232,448
    bytes of shared memory a block, weights resident while they take at
    most 96 KB."""
    from pytorch_hmm_tpu_torch.ops import emit

    for N in range(1, 2049):
        plan = emit.dq_plan(D, N)
        width = 8 * plan.tn
        assert 1 <= plan.tn <= 8 and plan.col_tiles == -(-N // 64)
        assert plan.col_tiles * width >= N > (plan.col_tiles - 1) * width
        assert plan.col_tiles * width - N < 8 * plan.col_tiles
        assert 0 < plan.smem <= emit.SMEM_LIMIT, (D, N, plan)
        assert plan.resident == (8 * -(-D // 16) * 16 * width <= emit.DQ_RESIDENT_BYTES)
    assert emit.dq_plan(80, 48)[:3] == (6, 1, True)
    assert emit.dq_plan(80, 256)[:2] == (8, 4)
    assert emit.dq_plan(80, 64)[:2] == (8, 1)


def test_forward_without_gradient_matches_the_autograd_function():
    """Where no input records a gradient the forward skips the autograd
    Function; it returns the same values, and with a gradient the
    Function still runs (a grad_fn, the same values)."""
    from pytorch_hmm_tpu_torch.ops import emit

    g = torch.Generator().manual_seed(3)
    x, wq, wl = torch.randn(2, 9, 5, generator=g), torch.rand(5, 7, generator=g), torch.randn(5, 7, generator=g)
    bias = torch.randn(7, generator=g)
    plain = emit.diag_quadratic(x, wq, wl, bias)
    assert plain.grad_fn is None
    tracked = emit.diag_quadratic(x, wq.requires_grad_(), wl, bias)
    assert tracked.grad_fn is not None
    torch.testing.assert_close(plain, tracked.detach(), rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(emit.diag_quadratic(x, wq, wl, bias), plain, rtol=0, atol=0)


# -- the mixture mode (the GMM decode's emission) ---------------------------------

def _gmm_problem(S, C, D, cov="diag", B=2, T=17, seed=6):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn(B, T, D, generator=g)
    means = torch.randn(S, C, D, generator=g)
    cov_p = 0.3 * torch.randn((S, C, D) if cov == "diag" else (D,), generator=g)
    logits = torch.randn(S, C, generator=g)
    return obs, means, cov_p, logits


@pytest.mark.parametrize("cov", ["diag", "tied"])
@pytest.mark.parametrize("S,C,D", [(12, 4, 80), (5, 3, 13), (40, 2, 80), (33, 8, 39)])
def test_mixture_reference_matches_the_composite(S, C, D, cov):
    """``diag_gmm_log_probs_reference`` on the tables ``gmm_log_probs``
    builds gives the composite's state scores (component scores, then the
    logsumexp over C) bit for bit: the same operations in the same order,
    ``log w`` added to each component score last."""
    from pytorch_hmm_tpu_torch import emissions
    from pytorch_hmm_tpu_torch.ops import emit

    obs, means, cov_p, logits = _gmm_problem(S, C, D, cov)
    want = emissions.gmm_log_probs(obs, means, cov_p, logits, cov)
    got = emit.diag_gmm_log_probs_reference(
        obs, *emissions._diag_mixture_tables(means, cov_p, logits, cov), C)
    assert got.shape == want.shape == (2, 17, S)
    assert torch.equal(got, want)
    assert emit.diag_gmm_log_probs(
        obs, *emissions._diag_mixture_tables(means, cov_p, logits, cov), C).equal(got)


@pytest.mark.parametrize("D", [1, 80, 256])
def test_mixture_plan_tiles_hold_whole_states(D):
    """The mixture plan's column tiles cover N = S·C and each holds whole
    states: up to 64 columns the one tile of ``dq_plan``; past that tiles
    of 8·tn columns, 8·tn a multiple of C, tn the largest ≤ 8 that is;
    where no tn is, the plan is None (C=9, C=11, C > 64)."""
    from pytorch_hmm_tpu_torch.ops import emit

    for C in range(1, 80):
        for S in range(1, 70):
            N = S * C
            plan = emit.mixture_plan(D, N, C)
            fits = [t for t in range(1, 9) if 8 * t % C == 0]
            if N > 64 and not fits:
                assert plan is None, (D, S, C)
                continue
            width = 8 * plan.tn
            assert plan.col_tiles * width >= N > (plan.col_tiles - 1) * width
            assert 0 < plan.smem <= emit.SMEM_LIMIT
            if N <= 64:
                assert plan == emit.dq_plan(D, N) and plan.col_tiles == 1
            else:
                assert plan.tn == max(fits) and width % C == 0
    assert emit.mixture_plan(80, 48, 4) == emit.dq_plan(80, 48)
    assert emit.mixture_plan(80, 256, 4)[:2] == (8, 4)
    assert emit.mixture_plan(80, 96, 3)[:2] == (6, 2)
    assert emit.mixture_plan(80, 90, 9) is None and emit.mixture_plan(80, 48, 5) is None


_ROUTE_CASES = {
    "diag": (dict(), True),
    "tied": (dict(cov="tied"), True),
    "a parameter records a gradient": (dict(grad="means"), False),
    "obs records a gradient": (dict(grad="obs"), False),
    "bf16 contractions": (dict(dtype=torch.bfloat16), False),
    "spherical": (dict(cov="spherical"), False),
    "full": (dict(cov="full"), False),
    "float64 tensors": (dict(f64=True), False),
    "no tiling holds whole states": (dict(S=10, C=9), False),
}


@pytest.mark.parametrize("case", list(_ROUTE_CASES))
def test_mixture_route_predicate(case):
    """Which ``gmm_log_probs`` calls row 1's mixture mode takes: diag or
    tied covariance, float32 contractions and tensors, no gradient
    recorded, a mixture plan; never a call off the card."""
    from pytorch_hmm_tpu_torch import emissions

    kw, want = _ROUTE_CASES[case]
    S, C, D, cov = kw.get("S", 12), kw.get("C", 4), 80, kw.get("cov", "diag")
    obs, means, cov_p, logits = _gmm_problem(S, C, D, "diag" if cov != "tied" else "tied")
    if cov == "spherical":
        cov_p = torch.zeros(S, C)
    elif cov == "full":
        cov_p = torch.zeros(S, C, D * (D + 1) // 2)
    if kw.get("f64"):
        obs, means, cov_p, logits = (t.double() for t in (obs, means, cov_p, logits))
    args = {"obs": obs, "means": means, "cov": cov_p, "logits": logits}
    if "grad" in kw:
        args[kw["grad"]].requires_grad_(True)
    call = (args["obs"], args["means"], args["cov"], args["logits"], cov, kw.get("dtype"))
    assert emissions._mixture_kernel_takes(*call) is want
    with torch.no_grad():
        assert emissions._mixture_kernel_takes(*call) is (want or "grad" in kw)
    assert emissions._mixture_route(*call) is False     # CPU tensors: the composite


def test_mixture_wrapper_on_cpu_runs_plain_version_without_launching():
    from pytorch_hmm_tpu_torch import emissions
    from pytorch_hmm_tpu_torch.ops import emit

    obs, means, cov_p, logits = _gmm_problem(3, 2, 6)
    tables = emissions._diag_mixture_tables(means, cov_p, logits, "diag")
    before = diag_quadratic.launches, diag_quadratic.mixture_launches
    got = emit.diag_gmm_log_probs(obs, *tables, 2)
    assert got.equal(emit.diag_gmm_log_probs_reference(obs, *tables, 2))
    assert (diag_quadratic.launches, diag_quadratic.mixture_launches) == before
    with pytest.raises(ValueError, match="log_norm"):
        emit.diag_gmm_log_probs(obs, *tables[:4], tables[4][:-1], 2)
    with pytest.raises(ValueError, match="log_norm"):
        emit.diag_gmm_log_probs(obs, *tables, 4)
    meta = [torch.empty(t.shape, device="meta") for t in (obs, *tables)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        emit.diag_gmm_log_probs(*meta, 2)
