"""``fbsum_smallk`` port: its plain version vs the JAX Pallas kernel, and
the E-step dispatch ``auto_forward_backward`` around it.

The JAX kernel runs in interpret mode on the CPU, as its own tests run
it, at the shapes of ``tests/test_ops_fbsum.py``; atol 2e-4 on alpha,
beta and log Z as there, on valid frames only when ragged (frames past
a row's end are unspecified). The CUDA kernel itself is checked against
the same plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_hmm_tpu.ops as jops
from pytorch_hmm_tpu.ops.fbsum import fbsum_smallk as jax_fbsum_smallk
from pytorch_hmm_tpu_torch import ops
from pytorch_hmm_tpu_torch.ops.fbsum import (
    fbsum_smallk,
    fbsum_smallk_reference,
    fbsum_supported,
)

ATOL = 2e-4


def _problem(B, T, S, seed):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(B, T, S)).astype(np.float32)
    la = np.array(jax.nn.log_softmax(jnp.asarray(rng.normal(size=(S, S)), jnp.float32), -1))
    lp = np.array(jax.nn.log_softmax(jnp.asarray(rng.normal(size=(S,)), jnp.float32)))
    return lo, la, lp


def _assert_valid_close(got, want, lengths):
    got, want = np.asarray(got), np.asarray(want)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL)


@pytest.mark.parametrize(
    "B,T,S,lens",
    [(3, 257, 5, None), (16, 250, 12, None), (2, 128, 4, None), (1, 50, 3, None),
     (4, 129, 16, None), (2, 300, 16, None),
     (3, 257, 5, (257, 100, 31)), (4, 130, 12, (130, 128, 64, 1)), (2, 300, 16, (299, 177))],
)
def test_reference_matches_jax_kernel(B, T, S, lens):
    lo, la, lp = _problem(B, T, S, seed=B * T + S)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    want = jax_fbsum_smallk(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp), jl)
    got = fbsum_smallk_reference(*(torch.from_numpy(a) for a in (lo, la, lp)), tl)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=ATOL)
    for g, w in zip(got[:2], want[:2]):
        _assert_valid_close(g.numpy(), w, lens or [T] * B)
    if lens is not None:
        # JAX's freeze: beta is 0 from each row's frame len-1 on.
        for b, n in enumerate(lens):
            assert torch.all(got[1][b, n - 1:] == 0)


def test_left_to_right_with_neg_inf_matches_jax_kernel():
    """-inf transitions: the JAX kernel clamps them at -1e30, the plain
    version keeps -inf; both give the same finite entries and no NaN."""
    S, B, T = 6, 2, 80
    a = 0.6 * np.eye(S) + 0.4 * np.eye(S, k=1)
    a[-1, -1] = 1.0
    with np.errstate(divide="ignore"):
        la = np.log(a).astype(np.float32)
    lo = np.random.default_rng(1).normal(size=(B, T, S)).astype(np.float32)
    lp = np.full((S,), -np.log(S), np.float32)
    want = jax_fbsum_smallk(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp))
    got = fbsum_smallk_reference(*(torch.from_numpy(x) for x in (lo, la, lp)))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert not np.isnan(g).any()
        finite = np.isfinite(g)
        assert np.all(w[~finite] < -1e29)
        np.testing.assert_allclose(g[finite], w[finite], atol=ATOL)


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    args = [torch.from_numpy(a) for a in _problem(3, 40, 7, seed=2)]
    before = fbsum_smallk.launches
    for g, w in zip(fbsum_smallk(*args), fbsum_smallk_reference(*args)):
        assert torch.equal(g, w)
    assert fbsum_smallk.launches == before


def test_wrapper_raises_off_cpu_instead_of_falling_back():
    lo, la, lp = (torch.empty(s, device="meta") for s in ((2, 10, 4), (4, 4), (4,)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fbsum_smallk(lo, la, lp)
    with pytest.raises(ValueError, match="K <= 32"):
        fbsum_smallk(torch.empty(2, 10, 33, device="meta"), torch.empty(33, 33, device="meta"),
                     torch.empty(33, device="meta"))
    with pytest.raises(ValueError, match="int32"):
        fbsum_smallk(lo, la, lp, torch.ones(2, dtype=torch.int64, device="meta"))


def test_fbsum_supported_takes_every_k_up_to_32():
    """No TPU VMEM gate: every K <= 32 at any batch."""
    assert fbsum_supported(1, 1) and fbsum_supported(16, 4096) and fbsum_supported(32, 64)
    assert not fbsum_supported(33, 1) and not fbsum_supported(0, 1)


@pytest.mark.parametrize("lens", [None, (90, 60, 17, 1)])
def test_shifted_forward_backward_matches_jax_kernel_path(monkeypatch, lens):
    """The CUDA branch of ``auto_forward_backward`` (per-frame max shift,
    fbsum, cumulative shift re-added), run on CPU tensors through the
    plain fbsum, against JAX's TPU branch (fbsum in interpret mode).
    Emissions at speech-like magnitudes so the shift matters."""
    B, T, S = 4, 90, 6
    lo, la, lp = _problem(B, T, S, seed=7)
    lo = 40.0 * lo - 120.0
    monkeypatch.setattr(jops, "pallas_available", lambda num_states: True)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    want = jops.auto_forward_backward(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp), jl)
    got = ops._shifted_forward_backward(*(torch.from_numpy(a) for a in (lo, la, lp)), tl)
    # The re-added cumulative shift reaches ~1e4 here, and the two
    # packages sum it in different orders: 2e-4 plus 4 f32 ulps of it.
    atol = ATOL + 4 * float(np.spacing(np.abs(np.asarray(want[3])).max().astype(np.float32)))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=atol)
    for g, w in zip(got[:3], want[:3]):
        g, w = g.numpy(), np.asarray(w)
        for b, n in enumerate(lens or [T] * B):
            np.testing.assert_allclose(g[b, :n], w[b, :n], atol=atol)


def test_auto_forward_backward_on_cpu_is_core():
    from pytorch_hmm_tpu_torch import core

    args = [torch.from_numpy(a) for a in _problem(2, 30, 5, seed=3)]
    lengths = torch.tensor([30, 9])
    for g, w in zip(ops.auto_forward_backward(*args, lengths),
                    core.forward_backward(*args, lengths)):
        assert torch.equal(g, w)
