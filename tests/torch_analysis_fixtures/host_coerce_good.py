"""GOOD: static metadata and Python ints stay on the host side."""
import torch


def step(x, k: int):
    rows = int(x.shape[0])  # a shape: host math, no read
    width = x.size(1)
    scale = int(k)  # a Python int parameter
    return x * (rows + width + scale)


def run(xs):
    return torch.func.vmap(step, in_dims=(0, None))(xs, 3)


def host_summary(x):
    # not a tick context: a host helper may read
    return int(x.sum(dtype=torch.int64))
