"""The streaming chunk decoders of the torch port against the JAX
package's: ``greedy_chunk_reference`` against ``pallas_greedy_chunk``
(interpret mode) and the XLA scan ``streaming._greedy_step_xla``;
``beam_chunk_multi_reference`` against ``pallas_beam_chunk_multi``
(interpret mode) and the per-stream XLA scan ``streaming._beam_scan_raw``.

The same numpy inputs go to both packages. States, carries, histories,
path lengths and beam scores are bit-identical. The greedy step's
log-scores are compared bit for bit with the same float32 sums taken in
numpy along the decoded path; their exp, which the JAX step returns, is
within one ulp (XLA's and torch's ``exp`` differ in the last bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu.ops.stream import pallas_greedy_chunk
from pytorch_hmm_tpu.ops.stream import stream_chunk_supported as jax_chunk_supported
from pytorch_hmm_tpu.ops.stream_multi import multi_stream_supported as jax_multi_supported
from pytorch_hmm_tpu.ops.stream_multi import pallas_beam_chunk_multi
from pytorch_hmm_tpu.streaming import _beam_scan_raw, _beam_step_xla, _greedy_step_xla
from pytorch_hmm_tpu_torch import ops
from pytorch_hmm_tpu_torch.streaming import _beam_scan_raw as torch_beam_scan_raw
from pytorch_hmm_tpu_torch.streaming import _beam_step


def _problem(T, S, seed, n=None, ties=False):
    """``log_a (S, S)`` and ``log_obs ((n,) T, S)`` from Dirichlet draws;
    with ``ties`` every entry is ``-log S`` (exact ties everywhere)."""
    rng = np.random.default_rng(seed)
    shape = (T,) if n is None else (n, T)
    if ties:
        c = np.float32(-np.log(np.float32(S)))
        return np.full((S, S), c, np.float32), np.full((*shape, S), c, np.float32)
    la = np.log(rng.dirichlet(np.ones(S), size=S) + 1e-8).astype(np.float32)
    lo = np.log(rng.dirichlet(np.ones(S), size=shape) + 1e-8).astype(np.float32)
    return la, lo


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _greedy_scores_numpy(la, lo, states, prev, has, n_valid):
    """The greedy step's log-score of each decoded state, as float32 sums
    in numpy along the path."""
    S = la.shape[0]
    log_s = np.float32(ops.stream.log_num_states(S))
    out = []
    for t, s in enumerate(states):
        out.append(la[prev, s] + lo[t, s] if has else lo[t, s] - log_s)
        if t < n_valid:
            prev, has = s, True
    return np.array(out, np.float32)


GREEDY_CASES = [
    (64, 12, 64, 0, False),
    (40, 5, 33, 2, False),     # invalid tail: the carry freezes
    (8, 3, 3, 3, False),       # mostly invalid
    (24, 6, 24, 4, True),      # exact ties everywhere
    (16, 4, 0, 5, False),      # no valid frame
]


@pytest.mark.parametrize("T,S,nv,seed,ties", GREEDY_CASES)
@pytest.mark.parametrize("has_prev", [False, True])
def test_greedy_chunk_reference_matches_jax(T, S, nv, seed, ties, has_prev):
    la, lo = _problem(T, S, seed, ties=ties)
    prev0 = 2 % S
    carry_j = (jnp.int32(prev0), jnp.bool_(has_prev))
    want = {
        "xla": _greedy_step_xla(jnp.asarray(la), jnp.asarray(lo), jnp.int32(nv), carry_j),
        "pallas": pallas_greedy_chunk(jnp.asarray(la), jnp.asarray(lo), jnp.int32(nv), carry_j),
    }
    carry_t = (torch.tensor(prev0, dtype=torch.int32), torch.tensor(has_prev))
    (prev, has), states, scores = ops.greedy_chunk_reference(*_t(la, lo), nv, carry_t)
    assert states.dtype == torch.int32 and prev.dtype == torch.int32
    for route, ((p_j, h_j), s_j, c_j) in want.items():
        np.testing.assert_array_equal(states.numpy(), np.asarray(s_j), err_msg=route)
        assert int(prev) == int(p_j) and bool(has) == bool(h_j), route
        np.testing.assert_array_max_ulp(torch.exp(scores).numpy(), np.asarray(c_j), maxulp=1)
    np.testing.assert_array_equal(
        scores.numpy(), _greedy_scores_numpy(la, lo, states.numpy(), prev0, has_prev, nv))
    # The dispatch and the wrapper take the plain version on CPU tensors.
    for fn in (ops.greedy_chunk, ops.auto_greedy_chunk):
        (p2, h2), s2, c2 = fn(*_t(la, lo), nv, carry_t)
        assert torch.equal(s2, states) and torch.equal(c2, scores)
        assert int(p2) == int(prev) and bool(h2) == bool(has)


def _beam_carry(N, W, H, S, path_len, seed):
    """Per-stream carries: a fresh beam (uniform prior, zero history)
    where ``path_len`` is 0, else random scores and histories."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, W)).astype(np.float32)
    scores -= scores.max(axis=1, keepdims=True)
    paths = rng.integers(0, S, size=(N, W, H)).astype(np.int32)
    for n, plen in enumerate(path_len):
        if plen == 0:
            scores[n] = -np.float32(ops.stream.log_num_states(S))
            paths[n] = 0
    states = np.tile(np.arange(W, dtype=np.int32) % S, (N, 1))
    return scores, states, paths, np.asarray(path_len, np.int32)


BEAM_CASES = {
    "first chunk, N=1": (1, 64, 12, 8, 165, 64, [0], False),
    "mixed path_len, N=3": (3, 48, 12, 8, 100, 48, [0, 30, 100], False),
    "W = S, n_valid < T": (2, 40, 6, 6, 50, 29, [0, 12], False),
    "forced ties": (2, 32, 6, 4, 40, 32, [0, 5], True),
    "T > H": (2, 64, 5, 4, 40, 60, [0, 40], False),
    "steady state, N=1": (1, 40, 7, 5, 50, 40, [50], False),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_chunk_multi_reference_matches_jax(case):
    N, T, S, W, H, nv, plen, ties = BEAM_CASES[case]
    la, lo = _problem(T, S, 7, n=N, ties=ties)
    carry = _beam_carry(N, W, H, S, plen, 11)
    got = ops.beam_chunk_multi_reference(*_t(la, lo), nv, _t(*carry))
    names = ("scores", "states", "paths", "path_len")
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.int32, torch.int32]
    pallas = pallas_beam_chunk_multi(jnp.asarray(la), jnp.asarray(lo), jnp.int32(nv),
                                     tuple(jnp.asarray(c) for c in carry))
    for g, w, name in zip(got, pallas, names):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"pallas {name}")
    for n in range(N):
        xla = _beam_scan_raw(jnp.asarray(la), jnp.asarray(lo[n]), jnp.int32(nv),
                             tuple(jnp.asarray(c[n]) for c in carry))
        for g, w, name in zip(got, xla[:4], names):
            np.testing.assert_array_equal(g[n].numpy(), np.asarray(w), err_msg=f"xla {name} {n}")
    for fn in (ops.beam_chunk_multi, ops.auto_beam_chunk_multi):
        for g, w in zip(fn(*_t(la, lo), nv, _t(*carry)), got):
            assert torch.equal(g, w)


def test_beam_n_valid_per_stream_matches_per_stream_xla():
    """The port's kernel takes ``n_valid`` per stream: each stream equals
    the XLA scan run on it alone with its own count."""
    N, T, S, W, H = 3, 32, 8, 4, 40
    la, lo = _problem(T, S, 21, n=N)
    carry = _beam_carry(N, W, H, S, [0, 7, 0], 22)
    nv = [32, 30, 5]
    got = ops.beam_chunk_multi_reference(*_t(la, lo), torch.tensor(nv, dtype=torch.int32),
                                         _t(*carry))
    for n in range(N):
        xla = _beam_scan_raw(jnp.asarray(la), jnp.asarray(lo[n]), jnp.int32(nv[n]),
                             tuple(jnp.asarray(c[n]) for c in carry))
        # The port's single-stream oracle returns the same scan carry.
        one = torch_beam_scan_raw(*_t(la, lo[n]), nv[n],
                                  (*_t(carry[0][n], carry[1][n], carry[2][n]),
                                   torch.tensor(carry[3][n])))
        for g, o, w in zip(got, one, xla[:4]):
            np.testing.assert_array_equal(g[n].numpy(), np.asarray(w))
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))
        assert int(one[4]) == int(xla[4])


def test_beam_step_chained_chunks_match_jax():
    """Three chunks through the single-stream step (fleet decode at N=1
    and the finalize): states, carry and renormalized scores equal the
    JAX step; confidence within one ulp."""
    S, W, H, T = 7, 5, 50, 40
    la, _ = _problem(4, S, 9)
    carry = _beam_carry(1, W, H, S, [0], 9)
    carry_j = (jnp.asarray(carry[0][0]), jnp.asarray(carry[1][0]), jnp.asarray(carry[2][0]),
               jnp.int32(0))
    carry_t = (*_t(carry[0][0], carry[1][0], carry[2][0]), torch.tensor(0, dtype=torch.int32))
    for i, nv in enumerate((40, 40, 23)):
        _, lo = _problem(T, S, 20 + i)
        carry_j, st_j, cf_j = _beam_step_xla(jnp.asarray(la), jnp.asarray(lo), jnp.int32(nv),
                                             carry_j)
        carry_t, st_t, cf_t = _beam_step(*_t(la, lo), nv, carry_t)
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
        np.testing.assert_array_max_ulp(cf_t.numpy(), np.asarray(cf_j), maxulp=1)
        for a, b in zip(carry_t, carry_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_log_num_states_is_the_jitted_constant():
    """``log S`` rounded once to f32 on the host is the constant XLA folds
    into a jitted program (as into the JAX package's greedy step), for
    every S the kernels take."""
    import jax

    sizes = range(1, ops.stream.MAX_STATES + 1)
    want = jax.jit(lambda: jnp.log(jnp.asarray([float(s) for s in sizes])))()
    got = np.array([ops.stream.log_num_states(s) for s in sizes], np.float32)
    np.testing.assert_array_equal(got, np.asarray(want))


GRID = [(s, t, w, h) for s in (1, 3, 12, 128, 129) for t in (1, 160, 1020, 1024, 1025)
        for w in (1, 3, 8, 9) for h in (1, 165, 1024, 1025)]


def test_supported_predicates_match_jax():
    for s, t, w, h in GRID:
        assert ops.stream_chunk_supported(s, t, w, h) == jax_chunk_supported(s, t, w, h)
        for n in (1, 4):
            assert ops.multi_stream_supported(n, s, t, w, h) == jax_multi_supported(n, s, t, w, h)


def test_multi_stream_supported_takes_any_fleet():
    """The JAX kernel caps a launch at 16 streams and a VMEM budget (TPU
    limits); the port's kernel runs one warp per stream at any N."""
    assert not jax_multi_supported(200, 12, 160, 8, 165)
    assert ops.multi_stream_supported(200, 12, 160, 8, 165)
    assert not ops.multi_stream_supported(200, 12, 160, 9, 165)


def test_kernel_wrappers_count_no_cpu_launch():
    la, lo = _problem(8, 4, 0)
    before = ops.greedy_chunk.launches, ops.beam_chunk_multi.launches
    ops.greedy_chunk(*_t(la, lo), 8, (torch.tensor(0, dtype=torch.int32), torch.tensor(False)))
    carry = _beam_carry(1, 2, 10, 4, [0], 0)
    ops.beam_chunk_multi(*_t(la, lo[None]), 8, _t(*carry))
    assert (ops.greedy_chunk.launches, ops.beam_chunk_multi.launches) == before
