"""The fused GMM decode (row 14 of the JAX package's kernels): its plain
version against ``pytorch_hmm_tpu.ops.fused.fused_gmm_viterbi`` in
interpret mode on the same numpy inputs, its envelope, and its place in
the GMM decode dispatch.

The two compute the same matmul-form emission in true f32 (JAX
``Precision.HIGHEST``), summed in another order, so near-ties could
flip: paths must be identical on these seeds, scores within rtol 1e-4,
atol 5e-3 (the JAX test's own against its unfused route,
tests/test_ops.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu.ops import fused as jfused
from pytorch_hmm_tpu_torch import core, emissions, ops
from pytorch_hmm_tpu_torch.ops import fused


def _gmm_problem(B, T, S, C, D, seed=1):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(B, T, D)).astype(np.float32),
        rng.normal(size=(S, C, D)).astype(np.float32),
        (0.1 * rng.normal(size=(S, C, D))).astype(np.float32),
        np.log(rng.dirichlet(np.ones(C), size=S)).astype(np.float32),
        np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32),
        np.log(rng.dirichlet(np.ones(S))).astype(np.float32),
    ]


CASES = {
    "S64 C2 D80": (_gmm_problem(3, 120, 64, 2, 80), None),
    "S40 C2 D13": (_gmm_problem(3, 130, 40, 2, 13, seed=2), None),
    "S128 C1 ragged": (_gmm_problem(4, 90, 128, 1, 24, seed=3), [90, 31, 1, 64]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(case):
    arrays, lengths = CASES[case]
    len_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    len_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    s_j, c_j = jfused.fused_gmm_viterbi(*(jnp.asarray(a) for a in arrays), len_j)
    s_t, c_t = fused.fused_gmm_viterbi_reference(*(torch.from_numpy(a) for a in arrays), len_t)
    assert s_t.dtype == torch.int32
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4, atol=5e-3)


def test_plain_version_matches_the_unfused_decode():
    """Against ``emissions.gmm_log_probs`` into ``core.viterbi`` (the
    route outside the envelope), on the same parameters."""
    arrays, _ = CASES["S64 C2 D80"]
    obs, means, log_vars, log_w, la, lp = (torch.from_numpy(a) for a in arrays)
    s_f, c_f = fused.fused_gmm_viterbi(obs, means, log_vars, log_w, la, lp)
    s_u, c_u = core.viterbi(emissions.gmm_log_probs(obs, means, log_vars, log_w, "diag"), la, lp)
    assert torch.equal(s_f, s_u)
    np.testing.assert_allclose(c_f.numpy(), c_u.numpy(), rtol=1e-4, atol=5e-3)


def test_emission_tables_match_the_diag_scores():
    """const + x²·A + x·Bm is the diag-Gaussian log-density plus log w
    (atol 1e-4: f32 sums of 80 terms of magnitude ~10)."""
    arrays, _ = CASES["S64 C2 D80"]
    obs, means, log_vars, log_w = (torch.from_numpy(a) for a in arrays[:4])
    a, bm, const = fused.emission_tables(means, log_vars, log_w)
    got = const + torch.einsum("btd,scd->btsc", obs * obs, a) + torch.einsum("btd,scd->btsc", obs, bm)
    want = emissions.gmm_component_log_probs(obs, means, log_vars, "diag") + log_w
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("S,C,cov", [(12, 4, "diag"), (12, 4, "full"), (128, 2, "diag"),
                                     (128, 1, "diag"), (64, 2, "diag"), (64, 3, "diag"),
                                     (40, 2, "diag"), (33, 4, "diag"), (129, 1, "diag"),
                                     (1, 16, "diag"), (1, 17, "diag"), (64, 2, "tied")])
def test_envelope_is_the_jax_kernels(S, C, cov):
    assert fused.fused_gmm_supported(S, C, cov) == jfused.fused_gmm_supported(S, C, cov)


def test_wrapper_refuses_shapes_outside_the_envelope():
    S, C, D = 64, 3, 8
    with pytest.raises(ValueError, match="outside the fused envelope"):
        fused.fused_gmm_viterbi(torch.zeros(1, 4, D), torch.zeros(S, C, D), torch.zeros(S, C, D),
                                torch.zeros(S, C), torch.zeros(S, S), torch.zeros(S))


def _meta_gmm(S, C, D=8):
    m = dict(device="meta")
    return (torch.empty(2, 5, D, **m), torch.empty(S, C, D, **m), torch.empty(S, C, D, **m),
            torch.empty(S, C, **m), torch.empty(S, S, **m), torch.empty(S, **m))


@pytest.mark.parametrize("S,C,cov,wrapper", [
    (12, 4, "diag", "diag_quadratic"),     # small-K first: emission, then smallk
    (64, 2, "diag", "fused_gmm_viterbi"),  # inside the fused envelope
    (128, 1, "diag", "fused_gmm_viterbi"),
    (64, 4, "diag", "diag_quadratic"),     # outside: emission, then pallas_viterbi
    (64, 2, "tied", "diag_quadratic"),
])
def test_gmm_decode_dispatch_order(S, C, cov, wrapper):
    """Off the CPU the JAX order holds: ``smallk`` first, then the fused
    kernel, then emission scoring into ``auto_viterbi``; each reaches its
    kernel wrapper, which refuses the meta device."""
    obs, means, lv, lw, la, lp = _meta_gmm(S, C)
    if cov == "tied":
        lv = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match=f"{wrapper} runs on CPU or CUDA"):
        ops.auto_gmm_viterbi(obs, means, lv, lw, la, lp, covariance_type=cov)


def test_cpu_decode_never_launches():
    arrays, _ = CASES["S40 C2 D13"]
    before = fused.fused_gmm_viterbi.launches
    got = ops.auto_gmm_viterbi(*(torch.from_numpy(a) for a in arrays))
    assert fused.fused_gmm_viterbi.launches == before
    assert got[0].shape == (3, 130)


# -- the kernel's shared-memory plan and table layout ------------------------


@pytest.mark.parametrize("D", [13, 80, 256])
def test_plan_fits_every_envelope_shape(D):
    """Every (S, C) the envelope takes has a layout within a block's shared
    memory: the ring, the delta vectors, the tables (whole or a k-block),
    the transposed k-block and the raw chunk."""
    for S in range(1, 129):
        for C in range(1, 17):
            if not fused.fused_gmm_supported(S, C, "diag"):
                continue
            plan = fused.fused_plan(S, C, D)
            assert plan.smem <= fused.SMEM_LIMIT, (S, C, D, plan)
            assert plan.kp >= S and plan.kp in (32, 64, 128)
            assert plan.sp >= S and plan.sp % 8 == 0 and plan.cp >= C
            assert plan.n == plan.sp * plan.cp <= 128
            assert 1 <= plan.kd <= D
            tab = 2 * (D if plan.resident else plan.kd) * plan.n
            raw = 64 * D if plan.raw else 0
            assert plan.smem == 80 + 4 * (2 * plan.kp + plan.n + 2 * 64 * plan.sp + tab + 2 * plan.kd * 68 + raw)


@pytest.mark.parametrize("S,C,D,resident,raw,kd", [
    (64, 2, 80, True, True, 80),      # the headline: whole tables, whole k
    (128, 1, 80, True, True, 80),     # the tight case: 213,072 bytes
    (40, 2, 13, True, True, 13),
    (96, 1, 96, True, True, 96),
    (128, 1, 256, False, True, 32),   # tables streamed a k-block at a time
    (8, 16, 256, False, True, 64),
    (128, 1, 2000, False, False, 64),  # the chunk read in place
])
def test_plan_keeps_tables_resident_while_they_fit(S, C, D, resident, raw, kd):
    plan = fused.fused_plan(S, C, D)
    assert (plan.resident, plan.raw, plan.kd) == (resident, raw, kd)


def test_probe_build_is_its_own_library():
    from pytorch_hmm_tpu_torch.ops import _build

    plain = _build.library_path("fused_gmm")
    probe = _build.library_path("fused_gmm", fused.PROBE_DEFINES)
    assert probe != plain and probe.name.startswith("libfused_gmm-")
