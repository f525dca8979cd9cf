#!/usr/bin/env python3
"""Rows 1, 15, 10, 12, 14 and 7 of the PyTorch port against another
checkout's kernels, on one CUDA GPU.

    python3 kernel_ab.py --base DIR [--rows dq bigk prob fused hsmm] [--probe]

Run from the root of a checkout. ``DIR`` is the root of another checkout
(for example an earlier commit unpacked with ``git archive`` into a
git-ignored directory); its ``pytorch_hmm_tpu_torch`` is imported as a
second package and builds its kernels into its own ``_build/``. Both
sets of kernels are checked against the plain versions of this checkout
on the same inputs, then timed in the order base, this, this, base:

* row 1 (``diag_quadratic``) at B=32, T=1000, D=80 and N = 48, 64, 256
  (the GMM decode, ``GaussianHMMLayer(64, 80)``, the S=64, C=4 decode):
  device time (a CUDA graph of 50 calls, median of 20 replays) and call
  time (CUDA events around one call, median of 20), beside
  ``torch.addmm`` of ``[x², x] @ [Wq; Wl] + b`` and, for this checkout,
  other column tilings of the same kernel;
* row 15 (``bigk_log_likelihood``) at the scoring shapes, at K=256 and
  K=128, and at B=4096 (CUDA events, median of 5), this checkout at its
  plan and at the other cluster sizes its kernel takes;
* rows 10 and 12 (``pallas_forward_prob``, ``pallas_fb_prob``) at (B, T,
  K) = (32, 131072, 64), (32, 4096, 64), (8, 4096, 12), (8, 1000, 128),
  (1, 131072, 64) and, past one wave of blocks, (512, 4096, 64), (512,
  4096, 12) and (512, 1000, 128): one raw launch each through the
  entry point's C function (``exp(log_a)``, the outputs' allocation and
  the kernel; CUDA events, median of 10, 5 at T=131072); checked against
  the plain versions at T ≤ 4096 and against the base's kernel at
  T=131072 (the plain chains are T-step Python loops), split as written;
* row 14 (``fused_gmm_viterbi``, ``--rows fused``) at chip_smoke's
  ``FUSED_CASES`` (S=64 C=2 D=80 at B=32 T=1000, S=128 C=1, S=40 C=2
  D=13, ragged) and at B=512, the wrapper's call (CUDA events, median of
  10), held to chip_smoke's frame agreement and score tolerance; at the
  headline also the same decode unfused (``gmm_log_probs``, then
  ``pallas_viterbi``: rows 1 and 13);
* row 7 (``hsmm_smallk_fb``, ``--rows hsmm``) at chip_smoke's
  ``_hsmm_cases`` (S=10 D=20 at B=32 T=1000, D=128, S=32, ragged, T<D,
  min_duration=3) and at B=512, held to chip_smoke's sum tolerances.

``--rows`` picks which to run (all by default), ``--prob-shapes`` which
shapes of rows 10 and 12. ``--probe`` also prints this checkout's phase
probes of rows 14 and 7 (``fused probe`` and ``hsmm probe`` lines, as
chip_smoke.py prints them).

Prints one line per measurement, the card's name and power limit, and a
JSON object of every number as the last line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

DQ_SHAPES = {"N=48": 48, "N=64": 64, "N=256": 256}
# Other (tn, column tiles) of this checkout's row 1 at each N.
DQ_ALT = {"N=48": [(3, 2)], "N=64": [(4, 2), (2, 4)], "N=256": [(4, 8), (6, 6)]}
BIGK_SHAPES = {
    "48x2048x512": (48, 2048, 512), "16x2048x1024": (16, 2048, 1024),
    "8x2048x256": (8, 2048, 256), "8x2048x128": (8, 2048, 128),
    "4096x256x256": (4096, 256, 256), "4096x256x512": (4096, 256, 512),
    "4096x256x1024": (4096, 256, 1024),
}
# Cluster sizes tried at each padded K (the plan's own is added).
BIGK_ALT = {128: [1, 2], 256: [1, 2, 4], 512: [4, 8], 1024: [16]}
BIGK_RUNS = 5
PROB_SHAPES = {"32x131072x64": (32, 131072, 64), "32x4096x64": (32, 4096, 64), "8x4096x12": (8, 4096, 12),
               "8x1000x128": (8, 1000, 128), "1x131072x64": (1, 131072, 64),
               # Past one wave of blocks on 132 SMs, where the blocks an SM
               # holds decide the time.
               "512x4096x64": (512, 4096, 64), "512x4096x12": (512, 4096, 12), "512x1000x128": (512, 1000, 128)}
PROB_CHAINS = {"pallas_forward_prob": ("forward", 1), "pallas_fb_prob": ("fb", 2)}
PROB_RS = 8
# Row 14 at the chip_smoke cases, and past one wave of blocks; (B, T, S, C,
# D, lengths). The headline also times the unfused route of the same
# decode (row 1, the logsumexp over C, then row 13).
FUSED_SHAPES = {"32x1000 S=64 C=2 D=80": (32, 1000, 64, 2, 80, None),
                "8x300 S=128 C=1": (8, 300, 128, 1, 80, None),
                "4x300 S=40 C=2 D=13": (4, 300, 40, 2, 13, None),
                "5x300 ragged": (5, 300, 64, 2, 80, [300, 31, 164, 1, 129]),
                "512x1000 S=64 C=2 D=80": (512, 1000, 64, 2, 80, None)}
# Row 7 at the chip_smoke cases, and past one wave; (B, T, S, D, lengths,
# min_duration).
HSMM_SHAPES = {"32x1000 S=10 D=20": (32, 1000, 10, 20, None, 1),
               "4x600 D=128": (4, 600, 10, 128, None, 1),
               "8x500 S=32": (8, 500, 32, 20, None, 1),
               "5x300 ragged": (5, 300, 9, 15, [300, 31, 164, 1, 129], 1),
               "3x12 T<D": (3, 12, 5, 20, None, 1),
               "4x300 min_duration=3": (4, 300, 10, 20, None, 3),
               "512x1000 S=10 D=20": (512, 1000, 10, 20, None, 1)}


ROWS = ("dq", "bigk", "prob", "fused", "hsmm")


def load_base(root: Path):
    """``root``'s port as the package ``base_port``."""
    pkg = root / "pytorch_hmm_tpu_torch"
    spec = importlib.util.spec_from_file_location("base_port", pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["base_port"] = mod
    spec.loader.exec_module(mod)
    import base_port.ops.bigk
    import base_port.ops.emit
    import base_port.ops.fused
    import base_port.ops.hsmm_smallk
    import base_port.ops.scan  # noqa: F401
    return mod


def run_dq(dev, base, out):
    import torch
    from pytorch_hmm_tpu_torch.ops import emit

    for tag, n in DQ_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(cs.SEED + n)
        x = torch.randn(cs.B, cs.T, cs.D, device=dev, generator=g)
        wq = torch.rand(cs.D, n, device=dev, generator=g) + 0.5
        wl = torch.randn(cs.D, n, device=dev, generator=g)
        bias = torch.randn(n, device=dev, generator=g)
        xx = torch.cat([x * x, x], dim=-1).reshape(cs.B * cs.T, 2 * cs.D)
        w2 = torch.cat([wq, wl], dim=0)
        want = emit.diag_quadratic_reference(x, wq, wl, bias)
        fns = {"base": lambda: base.ops.emit.diag_quadratic(x, wq, wl, bias),
               "this": lambda: emit.diag_quadratic(x, wq, wl, bias),
               "torch.addmm": lambda: torch.addmm(bias, xx, w2)}
        for tn, tiles in DQ_ALT[tag]:
            plan = emit._plan(cs.D, tn, tiles)
            fns[f"this tn={tn} tiles={tiles}"] = lambda p=plan: emit._launch(x, wq, wl, bias, p)
        res = {}
        for name, fn in fns.items():
            got = fn().reshape(want.shape)
            err = (got - want).abs().max().item()
            cs.check(torch.allclose(got, want, atol=cs.DQ_ATOL, rtol=cs.DQ_RTOL),
                     f"diag_quadratic {tag} {name}: max abs err {err}")
            res[name] = {"max_abs_err": err, "device_ms": [], "call_ms": []}
        order = ["base", *[k for k in fns if k != "base"], *reversed([k for k in fns if k != "base"]), "base"]
        for name in order:
            res[name]["device_ms"].append(cs.graph_ms(fns[name]))
            res[name]["call_ms"].append(cs.cuda_median_ms(fns[name]))
        out["diag_quadratic"][tag] = res
        for name, r in res.items():
            print(f"diag_quadratic {tag} {name}: device ms {r['device_ms']}, call ms {r['call_ms']}, "
                  f"max abs err {r['max_abs_err']:.3g}", flush=True)


def run_bigk(dev, base, out):
    import torch
    from pytorch_hmm_tpu_torch.ops import bigk

    for tag, (b, t, k) in BIGK_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(cs.SEED + k + b)
        lo, la, lp = cs._bigk_problem(dev, g, b, t, k)
        want = bigk.bigk_log_likelihood_reference(lo, la, lp, bigk.T_CHUNK)
        own = bigk.cluster_plan(k, b)
        sizes = sorted({own.cs, *BIGK_ALT.get(own.kp, [])})
        fns = {"base": lambda: base.ops.bigk.bigk_log_likelihood(lo, la, lp)}
        plans = {}
        for c in sizes:
            plan = bigk.cluster_plan(k, b, c)
            name = f"this CS={c}" + (" (plan)" if c == own.cs else "")
            plans[name] = plan
            fns[name] = lambda p=plan: bigk._launch(lo, la, lp, bigk.T_CHUNK, p)
        res = {}
        for name, fn in fns.items():
            got = fn()
            err = (got - want).abs()
            cs.check(bool((err <= cs.BIGK_ATOL + cs.BIGK_PLAIN_RTOL * want.abs()).all()),
                     f"bigk_log_likelihood {tag} {name}: max abs err {err.max().item()}")
            res[name] = {"max_abs_err": err.max().item(), "ms": []}
            if name in plans:
                res[name]["smem"] = plans[name].smem
                res[name]["active_clusters"] = bigk.active_clusters(k, plans[name], dev)
        order = ["base", *[k_ for k_ in fns if k_ != "base"], *reversed([k_ for k_ in fns if k_ != "base"]),
                 "base"]
        for name in order:
            res[name]["ms"].append(cs.cuda_median_ms(fns[name], runs=BIGK_RUNS, warmup=1))
        out["bigk_log_likelihood"][tag] = res
        for name, r in res.items():
            extra = (f", {r['smem']} B shared a CTA, {r['active_clusters']} clusters at once"
                     if "smem" in r else "")
            print(f"bigk_log_likelihood {tag} {name}: ms {r['ms']}, us a frame "
                  f"{min(r['ms']) * 1e3 / t:.3f}, max abs err {r['max_abs_err']:.3g}{extra}", flush=True)


def _prob_errs(got, want):
    """The split outputs' error against the tolerances of ``chip_smoke``
    (relative tables atol, shifts atol + rtol), as fractions of them."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:
            continue
        tol = cs.PROB_REL_ATOL if i % 2 == 0 else cs.PROB_ATOL + cs.PROB_RTOL * w.abs()
        worst = max(worst, ((g - w).abs() / tol).max().item())
    return worst


def run_prob(dev, base, out, shapes):
    import torch
    from pytorch_hmm_tpu_torch.ops import scan

    for tag in shapes:
        b, t, k = PROB_SHAPES[tag]
        g = torch.Generator(device=dev).manual_seed(cs.SEED + k + b + t)
        lo = torch.randn(b, t, k, device=dev, generator=g)
        la = torch.log_softmax(torch.randn(k, k, device=dev, generator=g), -1)
        lp = torch.log_softmax(torch.randn(k, device=dev, generator=g), -1)
        for row, (chains, n) in PROB_CHAINS.items():
            entry = {"forward": "scan_prob_forward_f32", "fb": "scan_prob_fb_f32"}[chains]

            def launch(mod):
                (ta, *tb), (sa, *sb) = mod._prob_launch(row, entry, lo, la, lp, PROB_RS, n)
                return ta, sa, (tb or [None])[0], (sb or [None])[0]

            base_fn = lambda: launch(base.ops.scan)  # noqa: E731
            fns = {"base": base_fn, "this": lambda: launch(scan)}
            if t <= cs.PROB_T:
                want = scan._forward_prob_split(lo, la, lp, PROB_RS) + (
                    scan._backward_prob_split(lo, la, PROB_RS) if chains == "fb" else (None, None))
            else:
                want = base_fn()
            res = {}
            for name, fn in fns.items():
                err = _prob_errs(fn(), want)
                cs.check(err <= 1.0, f"{row} {tag} {name}: {err:.3g} of the tolerance")
                res[name] = {"of_tolerance": err, "ms": []}
            del want
            runs = dict(runs=5, warmup=1) if t > cs.PROB_T else dict(runs=10, warmup=2)
            order = ["base", *[k_ for k_ in fns if k_ != "base"], *reversed([k_ for k_ in fns if k_ != "base"]),
                     "base"]
            for name in order:
                res[name]["ms"].append(cs.cuda_median_ms(fns[name], **runs))
            out[row][tag] = res
            for name, r in res.items():
                print(f"{row} {tag} {name}: ms {r['ms']}, us a frame {min(r['ms']) * 1e3 / t:.4f}, "
                      f"error {r['of_tolerance']:.3g} of the tolerance", flush=True)
        del lo


def _ab_order(fns):
    """base, the others, the others reversed, base."""
    rest = [k for k in fns if k != "base"]
    return ["base", *rest, *reversed(rest), "base"]


def run_fused(dev, base, out):
    import torch
    from pytorch_hmm_tpu_torch import emissions, ops
    from pytorch_hmm_tpu_torch.ops import fused

    for tag, (b, t, s, c, d, ln) in FUSED_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(cs.SEED + b + s + d)
        args = cs._gmm_inputs(dev, g, b, t, s, c, d, ln)
        obs, means, lv, lw, la, lp, _ = args
        want_st, want_sc = fused.fused_gmm_viterbi_reference(*args)
        fns = {"base": lambda: base.ops.fused.fused_gmm_viterbi(*args),
               "this": lambda: ops.fused_gmm_viterbi(*args)}
        if tag.startswith("32x1000"):
            fns["unfused (gmm_log_probs, pallas_viterbi)"] = lambda: ops.pallas_viterbi(
                emissions.gmm_log_probs(obs, means, lv, lw, "diag"), la, lp)
        res = {}
        for name, fn in fns.items():
            st, sc = fn()
            agree = (st == want_st).float().mean().item()
            err = (sc - want_sc).abs().max().item()
            cs.check(agree >= cs.FUSED_AGREE and torch.allclose(sc, want_sc, rtol=cs.FUSED_RTOL,
                                                                atol=cs.FUSED_ATOL),
                     f"fused_gmm_viterbi {tag} {name}: frame agreement {agree}, max abs score err {err}")
            res[name] = {"agreement": agree, "max_abs_err": err, "ms": []}
        for name in _ab_order(fns):
            res[name]["ms"].append(cs.cuda_median_ms(fns[name], runs=10, warmup=2))
        out["fused_gmm_viterbi"][tag] = res
        for name, r in res.items():
            print(f"fused_gmm_viterbi {tag} {name}: ms {r['ms']}, us a frame {min(r['ms']) * 1e3 / t:.4f}, "
                  f"frame agreement {r['agreement']}, max abs score err {r['max_abs_err']:.3g}", flush=True)


def run_hsmm(dev, base, out):
    import torch
    from pytorch_hmm_tpu_torch import ops

    for tag, (b, t, k, d, ln, md) in HSMM_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(cs.SEED + b + k + d)
        args = cs._hsmm_problem(dev, g, b, t, k, d, ln, md)
        want = ops.hsmm_smallk_fb_reference(*args)
        fns = {"base": lambda: base.ops.hsmm_smallk.hsmm_smallk_fb(*args),
               "this": lambda: ops.hsmm_smallk_fb(*args)}
        res = {}
        for name, fn in fns.items():
            err = max(cs._sum_err(gt, w, args[4], cs.HSMM_SUM_ATOL, cs.HSMM_SUM_RTOL)
                      for gt, w in zip(fn(), want))
            cs.check(err != float("inf"), f"hsmm_smallk_fb {tag} {name}: disagrees with its plain version")
            res[name] = {"max_abs_err": err, "ms": []}
        for name in _ab_order(fns):
            res[name]["ms"].append(cs.cuda_median_ms(fns[name], runs=10, warmup=2))
        out["hsmm_smallk_fb"][tag] = res
        for name, r in res.items():
            print(f"hsmm_smallk_fb {tag} {name}: ms {r['ms']}, us a frame {min(r['ms']) * 1e3 / t:.4f}, "
                  f"max abs err {r['max_abs_err']:.3g}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", type=Path, required=True, help="root of the checkout to compare with")
    parser.add_argument("--rows", nargs="+", choices=ROWS, default=list(ROWS),
                        help="which kernels to time (all by default)")
    parser.add_argument("--probe", action="store_true",
                        help="also print this checkout's phase probes of rows 14 and 7")
    parser.add_argument("--prob-shapes", nargs="+", choices=PROB_SHAPES, default=list(PROB_SHAPES),
                        help="which shapes of rows 10 and 12 to time (all by default)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    base = load_base(args.base.resolve())
    from pytorch_hmm_tpu_torch.ops import _build

    from pytorch_hmm_tpu_torch.ops import fused, hsmm_smallk

    sources = {"dq": ["diag_quadratic"], "bigk": ["bigk_scoring"], "prob": ["scan_prob"],
               "fused": ["fused_gmm", "diag_quadratic", "scan_bigk"], "hsmm": ["hsmm_smallk"]}
    probes = {"fused": ("fused_gmm", fused.PROBE_DEFINES), "hsmm": ("hsmm_smallk", hsmm_smallk.PROBE_DEFINES)}
    jobs = {(build, src, ()) for row in args.rows for src in sources[row]
            for build in (_build.build, base.ops._build.build)}
    if args.probe:
        jobs |= {(_build.build, *probes[row]) for row in args.rows if row in probes}
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: job[0](job[1], job[2]), jobs))
    card = cs.card_line()
    out = {"card": card, "diag_quadratic": {}, "bigk_log_likelihood": {}, "fused_gmm_viterbi": {},
           "hsmm_smallk_fb": {}, **{row: {} for row in PROB_CHAINS}, "probe": {}}
    runs = {"dq": run_dq, "bigk": run_bigk, "prob": lambda *a: run_prob(*a, args.prob_shapes),
            "fused": run_fused, "hsmm": run_hsmm}
    probe_phases = {"fused": cs.phase_fused_probe, "hsmm": cs.phase_hsmm_probe}
    with torch.no_grad():
        for row in args.rows:
            runs[row](dev, base, out)
            if args.probe and row in probe_phases:
                got = probe_phases[row](dev, torch.Generator(device=dev).manual_seed(cs.SEED + 12))
                for what, r in got.items():
                    print(cs.probe_line(what, r, card), flush=True)
                out["probe"].update(got)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
