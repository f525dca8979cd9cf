#!/usr/bin/env python3
"""Smoke run of the PyTorch port's GMM-HMM decode path on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (any
sm_90a card), PyTorch built for CUDA and the CUDA toolkit. It builds the
port's two CUDA kernels from ``pytorch_hmm_tpu_torch/csrc``, checks each
against its plain PyTorch version on the card, serves a few decode
requests through ``MixtureGaussianHMMLayer`` at the decode headline
shape (B=32, T=1000, S=12, C=4, D=80; random weights from a seed),
checks the results against the same layer on the CPU, and times the
kernels and the decode with CUDA events.

Phases, one line each: card, build, diag_quadratic, smallk_viterbi,
decode, timing. Any failure exits non-zero before the last line. On
success the last two lines are a JSON object describing each kernel and
``{"ok": true, "device": {...}}``. There is no CPU path: without a CUDA
device the script fails. It imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 0
# Decode headline shape: batch, frames, states, components, feature dim.
B, T, S, C, D = 32, 1000, 12, 4, 80
TIMED_RUNS = 20
# Tolerance of the JAX kernel's own test (tests/test_ops_emit.py).
DQ_ATOL, DQ_RTOL = 2e-4, 1e-5
VIT_SCORE_ATOL = 1e-5

KERNELS = {
    "diag_quadratic": {
        "source": "pytorch_hmm_tpu_torch/csrc/diag_quadratic.cu",
        "replaces": "pytorch_hmm_tpu/ops/emit.py:64",
    },
    "smallk_viterbi": {
        "source": "pytorch_hmm_tpu_torch/csrc/smallk_viterbi.cu",
        "replaces": "pytorch_hmm_tpu/ops/smallk.py:379",
    },
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def cuda_median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median over ``runs`` calls, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build():
    from pytorch_hmm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for name in KERNELS:
        _build.build(name)
    return time.perf_counter() - t0


def phase_diag_quadratic(dev, gen):
    """Kernel vs plain on the card; returns the headline max abs error."""
    import torch
    from pytorch_hmm_tpu_torch.ops.emit import diag_quadratic, diag_quadratic_reference

    errs = {}
    for (b, t, d, n) in [(B, T, D, S * C), (3, 257, 77, 37)]:
        x = torch.randn(b, t, d, device=dev, generator=gen)
        wq = torch.randn(d, n, device=dev, generator=gen) ** 2
        wl = torch.randn(d, n, device=dev, generator=gen)
        bias = torch.randn(n, device=dev, generator=gen)
        got = diag_quadratic(x, wq, wl, bias)
        want = diag_quadratic_reference(x, wq, wl, bias)
        torch.cuda.synchronize(dev)
        check(got.shape == (b, t, n), f"diag_quadratic shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        errs[(b, t, d, n)] = err
        check(torch.allclose(got, want, atol=DQ_ATOL, rtol=DQ_RTOL),
              f"diag_quadratic {(b, t, d, n)} disagrees: max abs err {err}")
    return errs


def _viterbi_cases(dev, gen):
    import torch

    def rand(b, t, k, lengths=None):
        lo = torch.randn(b, t, k, device=dev, generator=gen)
        la = torch.log_softmax(torch.randn(k, k, device=dev, generator=gen), -1)
        lp = torch.log_softmax(torch.randn(k, device=dev, generator=gen), -1)
        ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        return lo, la, lp, ln

    k = 6  # all ties (tests/test_ops.py:271)
    ties = (torch.zeros(2, 40, k, device=dev),
            torch.full((k, k), -torch.log(torch.tensor(float(k))).item(), device=dev),
            torch.full((k,), -torch.log(torch.tensor(float(k))).item(), device=dev), None)
    k = 4  # ties among {1..K-1} with a ~-inf diagonal (tests/test_ops.py:281)
    a = torch.full((k, k), 1.0 / (k - 1), dtype=torch.float64)
    a.fill_diagonal_(0.0)
    bracketed = (torch.zeros(2, 50, k, device=dev),
                 torch.log(a + 1e-300).float().to(dev),
                 torch.full((k,), -torch.log(torch.tensor(float(k))).item(), device=dev), None)
    return {
        "headline": rand(B, T, S),
        "K=32": rand(8, 500, 32),
        "ragged": rand(5, 300, 9, [300, 31, 164, 1, 129]),
        "T=1": rand(3, 1, 5),
        "all-ties": ties,
        "bracketed-ties": bracketed,
    }


def phase_smallk_viterbi(dev, gen):
    """Kernel vs plain on identical log-obs; returns the max abs score error."""
    import torch
    from pytorch_hmm_tpu_torch.ops.smallk import smallk_viterbi, smallk_viterbi_reference

    worst = 0.0
    for name, (lo, la, lp, ln) in _viterbi_cases(dev, gen).items():
        s1, c1 = smallk_viterbi(lo, la, lp, ln)
        s0, c0 = smallk_viterbi_reference(lo, la, lp, ln)
        torch.cuda.synchronize(dev)
        check(s1.dtype == torch.int32 and s1.shape == lo.shape[:2],
              f"smallk_viterbi {name}: states {s1.dtype} {tuple(s1.shape)}")
        check(torch.equal(s1, s0), f"smallk_viterbi {name}: paths differ")
        err = (c1 - c0).abs().max().item()
        check(err <= VIT_SCORE_ATOL, f"smallk_viterbi {name}: score err {err}")
        worst = max(worst, err)
    return worst


def make_requests(dev):
    """A decode batch drawn from a left-to-right walk over random
    Gaussians, plus ragged lengths (one full row, one of length 1)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    centers = torch.randn(S, D, device=dev, generator=gen)
    seg = torch.randint(1, 2 * T // S, (B, 1), device=dev, generator=gen)
    states = (torch.arange(T, device=dev)[None, :] // seg) % S
    obs = centers[states] + torch.randn(B, T, D, device=dev, generator=gen)
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen, dtype=torch.int32)
    lengths[0], lengths[1] = T, 1
    return obs.contiguous(), lengths


def phase_decode(dev):
    """Serve three requests through the layer on the card, count kernel
    launches, and check the results against the layer on the CPU."""
    import torch
    from pytorch_hmm_tpu_torch import MixtureGaussianHMMLayer, core
    from pytorch_hmm_tpu_torch.ops import MAX_SMALLK, auto_gmm_viterbi
    from pytorch_hmm_tpu_torch.ops.emit import diag_quadratic
    from pytorch_hmm_tpu_torch.ops.smallk import smallk_viterbi

    layer = MixtureGaussianHMMLayer(
        S, D, num_components=C, covariance_type="diag",
        generator=torch.Generator().manual_seed(SEED), device=dev,
    ).eval()
    obs, lengths = make_requests(dev)

    diag_quadratic.launches = 0
    smallk_viterbi.launches = 0
    full = layer(obs, return_log_probs=True)
    ragged = layer(obs, return_log_probs=True, lengths=lengths)
    served = layer.make_decoder()(obs, return_log_probs=True)
    torch.cuda.synchronize(dev)
    launches = {"diag_quadratic": diag_quadratic.launches,
                "smallk_viterbi": smallk_viterbi.launches}
    for name, n in launches.items():
        check(n > 0, f"the decode path never launched {name}")

    cpu = MixtureGaussianHMMLayer(S, D, num_components=C, covariance_type="diag").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    obs_cpu, lengths_cpu = obs.cpu(), lengths.cpu()
    ref_full = cpu(obs_cpu, return_log_probs=True)
    ref_ragged = cpu(obs_cpu, return_log_probs=True, lengths=lengths_cpu)

    agreement = {}
    for name, (st, sc), (rst, rsc) in [("full", full, ref_full),
                                       ("ragged", ragged, ref_ragged),
                                       ("make_decoder", served, ref_full)]:
        st, sc = st.cpu(), sc.cpu()
        check(st.dtype == torch.int32 and st.shape == (B, T), f"{name}: states {st.dtype} {tuple(st.shape)}")
        check(sc.shape == (B,) and bool(torch.isfinite(sc).all()), f"{name}: scores not finite")
        check(int(st.min()) >= 0 and int(st.max()) < S, f"{name}: state out of range")
        agreement[name] = (st == rst).float().mean().item()
        check(agreement[name] >= 0.999, f"{name}: frame agreement {agreement[name]} < 0.999")
        check(torch.allclose(sc, rsc, rtol=1e-5, atol=0.0),
              f"{name}: scores differ, max rel {((sc - rsc).abs() / rsc.abs()).max().item()}")
    # Padded frames repeat each row's last valid state.
    st = ragged[0].cpu()
    for b in range(B):
        n = int(lengths_cpu[b])
        check(bool((st[b, n - 1:] == st[b, n - 1]).all()), f"row {b}: padding not repeated")

    # The card's trellis on the CPU's log-obs must give the CPU's paths.
    dec_cpu = cpu.make_decoder()
    lo_cpu = dec_cpu.log_obs(obs_cpu)
    for ln in (None, lengths_cpu):
        rs, rc = core.viterbi(lo_cpu, dec_cpu.log_a, dec_cpu.log_pi, ln)
        gs, gc = smallk_viterbi(lo_cpu.to(dev), dec_cpu.log_a.to(dev), dec_cpu.log_pi.to(dev),
                                None if ln is None else ln.to(dev))
        check(torch.equal(gs.cpu(), rs), "card trellis on CPU log-obs: paths differ")
        check((gc.cpu() - rc).abs().max().item() <= VIT_SCORE_ATOL,
              "card trellis on CPU log-obs: scores differ")

    # More states than the trellis kernel takes must raise, not fall back.
    big = MAX_SMALLK + 1
    try:
        auto_gmm_viterbi(obs[:1, :8], torch.zeros(big, 1, D, device=dev),
                         torch.zeros(big, 1, D, device=dev), torch.zeros(big, 1, device=dev),
                         torch.zeros(big, big, device=dev), torch.zeros(big, device=dev))
    except NotImplementedError:
        pass
    else:
        raise SmokeFailure(f"S={big} on CUDA did not raise NotImplementedError")
    return layer, obs, launches, agreement


def phase_timing(dev, gen, layer, obs):
    import torch
    from pytorch_hmm_tpu_torch.ops.emit import diag_quadratic, diag_quadratic_reference
    from pytorch_hmm_tpu_torch.ops.smallk import smallk_viterbi, smallk_viterbi_reference

    n = S * C
    x = torch.randn(B, T, D, device=dev, generator=gen)
    wq = torch.rand(D, n, device=dev, generator=gen) + 0.5
    wl = torch.randn(D, n, device=dev, generator=gen)
    bias = torch.randn(n, device=dev, generator=gen)
    lo = torch.randn(B, T, S, device=dev, generator=gen)
    la = torch.log_softmax(torch.randn(S, S, device=dev, generator=gen), -1)
    lp = torch.log_softmax(torch.randn(S, device=dev, generator=gen), -1)
    return {
        "diag_quadratic": (cuda_median_ms(lambda: diag_quadratic(x, wq, wl, bias)),
                           cuda_median_ms(lambda: diag_quadratic_reference(x, wq, wl, bias))),
        "smallk_viterbi": (cuda_median_ms(lambda: smallk_viterbi(lo, la, lp)),
                           cuda_median_ms(lambda: smallk_viterbi_reference(lo, la, lp))),
        "decode": cuda_median_ms(lambda: layer(obs, return_log_probs=True)),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import pytorch_hmm_tpu_torch

    pkg_root = Path(pytorch_hmm_tpu_torch.__file__).resolve().parent.parent
    check(pkg_root == HERE, f"pytorch_hmm_tpu_torch imported from {pkg_root}, not this checkout")
    check("jax" not in sys.modules, "the port imported jax")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"nvidia-smi: {card}", flush=True)

    print(f"build: {phase_build():.1f} s for {', '.join(KERNELS)} (nvcc, sm_90a)", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    dq_errs = phase_diag_quadratic(dev, gen)
    print("diag_quadratic vs plain: ok, max abs err "
          + ", ".join(f"{k}: {v:.3g}" for k, v in dq_errs.items())
          + f" (atol {DQ_ATOL}, rtol {DQ_RTOL}, TF32 off)", flush=True)

    vit_err = phase_smallk_viterbi(dev, gen)
    print(f"smallk_viterbi vs plain: ok, paths identical on 6 cases, max abs score err {vit_err:.3g}",
          flush=True)

    layer, obs, launches, agreement = phase_decode(dev)
    print(f"decode (B={B}, T={T}, S={S}, C={C}, D={D}): ok, launches {launches}, "
          f"frame agreement with CPU {agreement}", flush=True)

    times = phase_timing(dev, gen, layer, obs)
    for name in KERNELS:
        ms, plain = times[name]
        print(f"timing {name}: {ms:.4f} ms kernel, {plain:.4f} ms plain torch "
              f"(median of {TIMED_RUNS}, CUDA events) on {card}", flush=True)
    print(f"timing decode: {times['decode']:.4f} ms per request of {B}x{T} frames "
          f"(median of {TIMED_RUNS}, CUDA events) on {card}", flush=True)

    errs = {"diag_quadratic": dq_errs[(B, T, D, S * C)], "smallk_viterbi": vit_err}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1]}
        for name in KERNELS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
