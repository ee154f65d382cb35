"""BAD: reductions whose accumulator torch widens to int64 unseen."""
import torch


def counts(mask, plane):
    alive = mask.sum()  # finding: implicit-accum-dtype
    rank = torch.cumsum(plane, 0)  # finding: implicit-accum-dtype
    prod = torch.prod(plane.to(torch.int32))  # finding: implicit-accum-dtype
    return alive, rank, prod
