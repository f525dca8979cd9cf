"""The whole step's share of the card's float32 peak: the model's
operations for the window's valid frames (the family's
``flops_per_frame``), over the window's seconds, over 67 TFLOP/s."""

from bench_torch.peaks import F32_FLOPS


def read(r):
    w = r.window
    if not w["calls"] or not w["flops"]:
        return None
    return 100.0 * w["flops"] / w["seconds"] / F32_FLOPS
