"""Shared pieces of the output checks."""

import math
import statistics


def worst(values):
    """The largest of ``values``; NaN if any is NaN or there are none."""
    values = [float(v) for v in values]
    if not values or any(math.isnan(v) for v in values):
        return math.nan
    return max(values)


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf. ``keep`` limits the leaves compared."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].double().norm()) for k in names}
    pn = {k: float(prog[k].double().norm()) for k in names}
    med = statistics.median(rn.values())
    return worst(abs(pn[k] - rn[k]) / max(rn[k], med) for k in names)
