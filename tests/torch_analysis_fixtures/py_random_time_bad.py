"""BAD: global random and clock state in device code."""
import random
import time

import numpy as np
import torch


def step(x):
    t = time.time()  # finding: py-random-time
    r = random.random()  # finding: py-random-time
    return x * r + t


def init(n):
    noise = np.random.rand(n)  # finding: py-random-time
    perm = torch.randperm(n)  # finding: py-random-time
    return noise, perm


def run(xs):
    return torch.func.vmap(step)(xs)
