"""BAD: a device sync in library code."""
import torch


def step(x):
    y = x + 1
    torch.cuda.synchronize()  # finding: block-until-ready
    return y
