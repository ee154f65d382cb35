"""BAD: an assert over a tensor inside a tick context."""
import torch


def step(x):
    assert (x >= 0).all()  # finding: assert-on-traced
    return x


def run(xs):
    return torch.func.vmap(step)(xs)
