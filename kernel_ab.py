#!/usr/bin/env python3
"""Rows 1 and 15 of the PyTorch port against another checkout's kernels,
on one CUDA GPU.

    python3 kernel_ab.py --base DIR

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
  plan and at the other cluster sizes its kernel takes.

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


def load_base(root: Path):
    """``root``'s port as the package ``base_port``."""
    pkg = root / "pytorch_hmm_tpu_torch"
    spec = importlib.util.spec_from_file_location("base_port", pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["base_port"] = mod
    spec.loader.exec_module(mod)
    import base_port.ops.bigk
    import base_port.ops.emit  # noqa: F401
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", type=Path, required=True, help="root of the checkout to compare with")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    base = load_base(args.base.resolve())
    from pytorch_hmm_tpu_torch.ops import _build

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda f: f(), [lambda: _build.build("diag_quadratic"), lambda: _build.build("bigk_scoring"),
                                      lambda: base.ops._build.build("diag_quadratic"),
                                      lambda: base.ops._build.build("bigk_scoring")]))
    card = cs.card_line()
    out = {"card": card, "diag_quadratic": {}, "bigk_log_likelihood": {}}
    with torch.no_grad():
        run_dq(dev, base, out)
        run_bigk(dev, base, out)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
