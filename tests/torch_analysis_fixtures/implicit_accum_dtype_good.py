"""GOOD: the accumulator's dtype is named, or the operand is pinned."""
import math

import torch


def counts(mask, plane, xs):
    alive = mask.sum(dtype=torch.int32)
    rank = torch.cumsum(plane, 0, dtype=torch.int64)
    mean = plane.float().sum() / plane.numel()
    wide = torch.cumsum(plane.to(torch.int64), 0)
    cells = math.prod(xs)
    return alive, rank, mean, wide, cells
