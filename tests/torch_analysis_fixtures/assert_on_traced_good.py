"""GOOD: asserts over static shapes only."""
import torch


def step(x):
    assert x.ndim == 1
    assert x.shape[0] > 0
    return x


def run(xs):
    return torch.func.vmap(step)(xs)
