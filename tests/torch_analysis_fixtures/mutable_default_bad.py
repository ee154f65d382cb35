"""BAD: mutable and tensor-valued default arguments."""
import numpy as np
import torch


def a(x, seen=[]):  # finding: mutable-default
    return x, seen


def b(x, table={}):  # finding: mutable-default
    return x, table


def c(x, base=torch.zeros(4, dtype=torch.int32)):  # finding: mutable-default
    return x + base


def d(x, host=np.arange(3)):  # finding: mutable-default
    return x, host
