"""The cuBLAS products of ``models/neural.py`` in a training step: the
transition MLP, the prosody projection, the observation trunk, the head's
mean and log variance and its three state products, forward and
backward (``families/neural_hmm.products``), over the valid frames,
and the per-call products of the head's state tables (``ms``, ``lvs``:
``(S, H) @ (H, D)`` twice, forward and both gradients). Bytes: each
product's operands read once and its result written once.

The pattern matches every kernel of those products that the trace names:
cuBLAS's float32 GEMM kernels (``sm80_xmma_gemm_f32f32...``,
``cutlass_80_simt_sgemm...``, their split-K launches) and cuBLASLt's
split-K reductions (``splitKreduce_kernel``). The harness counts one
launch's work times the launches it finds, so :func:`work` gives a
step's products over ``LAUNCHES``, the launches of one step that the
pattern matches (the 37 products below run as 39 GEMM launches and 10
reductions on an H100 under torch 2.11 with CUDA 12.8; another cuBLAS
that picks other kernels moves the count, and the share with it)."""

from bench_torch.families.neural_hmm import products

PATTERN = r"(?i)gemm|splitKreduce"
LAUNCHES = 49


def _products(s):
    """``(rows, in, out, backward products)`` of each product a step: 13
    forward (8 Linears, 2 table products, 3 state products), 24 backward."""
    K, H, D = s["K"], s["H"], s["D"]
    return [(s["frames"], i, o, n) for i, o, n in products(s)] + [(K, H, D, 2), (K, H, D, 2)]


def work(s):
    nbytes = flops = 0
    for rows, i, o, n in _products(s):
        flops += 2 * rows * i * o * (1 + n)
        # forward (rows·in + in·out + rows·out); the input's gradient
        # (rows·out + out·in + rows·in); the weight's (in·rows + rows·out + in·out)
        nbytes += 4 * (rows * i + i * o + rows * o) * (1 + n)
    return nbytes / LAUNCHES, flops / LAUNCHES
