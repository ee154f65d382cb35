"""BAD: numpy on tensors inside a tick context."""
import numpy as np
import torch


def step(x):
    total = np.sum(x)  # finding: np-on-traced
    arr = np.asarray(x)  # finding: np-on-traced
    return x + total + arr[0]


def run(xs):
    return torch.func.vmap(step)(xs)
