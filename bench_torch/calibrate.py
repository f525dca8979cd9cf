#!/usr/bin/env python3
"""Readings that the limits of a cell's output check are set from.

    python3 bench_torch/calibrate.py --workload <name> [--seeds 12] [--control-seeds 3]
        [--fault-seeds 3] [--first-seed N] [--seconds 2] [--out FILE]

In one process, on the card: the numbers that the check compares for
sound runs of the port on ``--seeds`` seeds (the lower readings), for the
control (the plain reference in float32 with TF32 products in the port's
place) and for each planted fault (``faults.py``) on their seeds (the
upper readings); and, with ``--witness-seeds``, for the plain reference
in float32 with float32 products in the port's place (what float32 alone
costs). Decode runs a short window of ``--seconds`` at the
cell's own load before its check; training needs none. One JSON line a
reading; ``--out`` writes them to a file as well.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def reading(cell, kind, seed, seconds, device, fault=None):
    import torch

    from bench_torch import faults, harness

    t0 = time.perf_counter()
    session = harness.make_session(cell.cfg, cell.traffic, seed, device)
    if kind == "control":
        harness.entry(cell.traffic).control(session)
    elif kind == "witness":
        from bench_torch.reference.tf32 import exact_matmul
        harness.entry(cell.traffic).control(session, exact_matmul)
    elif kind == "fault":
        faults.plant(session, fault)
    session.warm()
    window = harness.run_window(session, seconds if cell.traffic["entry"] == "decode" else 0)
    session.free()
    values = session.judge()
    details = getattr(session, "details", None)
    del session
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"workload": cell.name, "kind": kind if fault is None else f"fault:{fault}",
            "seed": seed, "values": values, "calls": window["calls"],
            "seconds": time.perf_counter() - t0, **({"leaves": details} if details else {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--witness-seeds", type=int, default=0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from bench_torch import faults, harness

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    seed = args.first_seed
    plan = []
    for _ in range(args.seeds):
        plan.append(("program", seed, None))
        seed += 1
    for i in range(args.control_seeds):
        plan.append(("control", args.first_seed + i, None))
    for i in range(args.witness_seeds):
        plan.append(("witness", args.first_seed + i, None))
    for fault in faults.FAULTS[cell.traffic["entry"]]:
        for i in range(args.fault_seeds):
            plan.append(("fault", args.first_seed + i, fault))
    lines = []
    for kind, s, fault in plan:
        line = reading(cell, kind, s, args.seconds, args.device, fault)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
