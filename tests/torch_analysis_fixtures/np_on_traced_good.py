"""GOOD: numpy on static shapes and host constants only."""
import numpy as np
import torch


def step(x):
    cells = int(np.prod(x.shape))
    table = np.arange(4, dtype=np.int32)
    return x + cells + int(table[1])


def run(xs):
    return torch.func.vmap(step)(xs)
