"""GOOD: None defaults built in the function, immutable constants."""
import torch


def a(x, seen=None, dev=torch.device("cpu"), shape=(4,)):
    seen = [] if seen is None else seen
    return x, seen, dev, shape
