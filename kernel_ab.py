#!/usr/bin/env python3
"""Rows 1, 15, 10 and 12 of the PyTorch port against another checkout's
kernels, on one CUDA GPU.

    python3 kernel_ab.py --base DIR [--rows dq bigk prob]

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
  T=131072 (the plain chains are T-step Python loops), split as written.

``--rows`` picks which of the three to run (all by default),
``--prob-shapes`` which shapes of rows 10 and 12.

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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", type=Path, required=True, help="root of the checkout to compare with")
    parser.add_argument("--rows", nargs="+", choices=("dq", "bigk", "prob"), default=["dq", "bigk", "prob"],
                        help="which kernels to time (all by default)")
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

    sources = {"dq": "diag_quadratic", "bigk": "bigk_scoring", "prob": "scan_prob"}
    jobs = [(build, sources[row]) for row in args.rows for build in (_build.build, base.ops._build.build)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: job[0](job[1]), jobs))
    card = cs.card_line()
    out = {"card": card, "diag_quadratic": {}, "bigk_log_likelihood": {}, **{row: {} for row in PROB_CHAINS}}
    runs = {"dq": run_dq, "bigk": run_bigk, "prob": lambda *a: run_prob(*a, args.prob_shapes)}
    with torch.no_grad():
        for row in args.rows:
            runs[row](dev, base, out)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
