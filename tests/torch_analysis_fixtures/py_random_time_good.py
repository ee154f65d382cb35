"""GOOD: explicit generators threaded from a seed."""
import random

import numpy as np
import torch


def init(n, seed):
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=gen)
    pick = random.Random(seed).randrange(n)
    return rng.random(n), perm, pick
