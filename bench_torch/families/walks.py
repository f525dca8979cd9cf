"""Pools of padded batches, drawn on the device from the seed.

Every seed gets the same multiset of utterance lengths: an even grid over
``[min_frames, max_frames]`` for all rows but one a batch, which holds
``max_frames``; the seed shuffles the grid over the pool. So the work of a
pool is the same on every seed, and only the content moves.
"""

import torch


def lengths(traffic, gen, device):
    """``(P, B)`` int32 valid lengths."""
    P, B = traffic["pool"], traffic["batch"]
    lo, hi = traffic["min_frames"], traffic["max_frames"]
    n = P * (B - 1)
    grid = lo + (hi - lo) * (torch.arange(n, device=device, dtype=torch.float64) + 0.5) / n
    grid = grid.round().to(torch.int32)[torch.randperm(n, generator=gen, device=device)]
    out = torch.full((P, B), hi, dtype=torch.int32, device=device)
    out[:, 1:] = grid.reshape(P, B - 1)
    return out


def segments(lens, num_states, max_frames, max_duration, gen, device):
    """``(P, B, T)`` state of each frame: segments of 2..``max_duration``
    frames, each of a state other than the one before it."""
    P, B = lens.shape
    n = max_frames // 2 + 1
    dur = torch.randint(2, max_duration + 1, (P * B, n), generator=gen, device=device)
    step = torch.randint(1, num_states, (P * B, n), generator=gen, device=device)
    first = torch.randint(0, num_states, (P * B, 1), generator=gen, device=device)
    seg_state = (first + torch.cumsum(step, 1) - step[:, :1]) % num_states
    ends = torch.cumsum(dur, 1)
    t = torch.arange(max_frames, device=device).expand(P * B, -1).contiguous()
    seg = torch.searchsorted(ends, t, right=True)
    return seg_state.gather(1, seg).reshape(P, B, max_frames)


def pad_zero(obs, lens):
    """Zero the frames past each row's length (``obs (P, B, T, D)``)."""
    T = obs.shape[2]
    valid = torch.arange(T, device=obs.device)[None, None] < lens[..., None]
    return obs * valid[..., None]
