#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card of this machine.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this directory
and ``pytorch_hmm_tpu_torch``. Prints what it measured and checked on
standard error, each number compared beside its limit last, and one JSON
object as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last. Exits 2, printing no result, where
PyTorch sees no CUDA card or fewer than the cell asks for, and 3, naming
them on standard error, where ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``pytorch_hmm_tpu`` is loaded once the window has closed.

The process keeps to one CPU core, the last it may use, with one thread
for PyTorch's CPU work: the card has one caller, and a caller that moves
between cores reads slower and less steadily.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

    from bench_torch import harness

    cell = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    except harness.ForeignModules as e:
        print(e, file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_plain(out)), flush=True)
    return 0


def _plain(x):
    """``x`` as strict JSON takes it: an infinite number as the largest
    float of its sign, NaN as null."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, float) and x != x:
        return None
    if isinstance(x, float) and abs(x) == float("inf"):
        return sys.float_info.max if x > 0 else -sys.float_info.max
    return x


if __name__ == "__main__":
    sys.exit(main())
