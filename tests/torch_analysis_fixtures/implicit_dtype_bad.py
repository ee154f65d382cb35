"""BAD: constructors and scalar selects with torch's default dtype."""
import torch

ALIVE, FAULTY = 0, 2


def make(n, mask):
    a = torch.zeros(n)  # finding: implicit-dtype (float32)
    b = torch.arange(n)  # finding: implicit-dtype (int64)
    c = torch.full((n,), -1)  # finding: implicit-dtype (int64)
    d = torch.where(mask, 1, 0)  # finding: implicit-dtype (int64)
    e = torch.where(mask, FAULTY, ALIVE)  # finding: implicit-dtype (int64)
    return a, b, c, d, e
