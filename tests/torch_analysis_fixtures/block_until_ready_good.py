"""GOOD: no sync; the caller decides when to wait."""
import torch


def step(x):
    return x + torch.ones_like(x)
