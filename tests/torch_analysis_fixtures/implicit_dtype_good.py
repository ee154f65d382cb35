"""GOOD: every constructor names its dtype; a select keeps a tensor branch."""
import torch

i32 = dict(dtype=torch.int32)


def make(n, mask, plane):
    a = torch.zeros(n, dtype=torch.int32)
    b = torch.arange(n, dtype=torch.int64)
    c = torch.full((n,), -1, **i32)
    d = torch.where(mask, plane, 0)
    e = torch.zeros_like(plane)
    return a, b, c, d, e
