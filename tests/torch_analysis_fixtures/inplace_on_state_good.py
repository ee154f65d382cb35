"""GOOD: new tensors, and in-place writes only into the tick's own copies."""
import torch


def tick(state, inputs):
    known = state.known.clone()
    known[0] = True
    status = state.status + 1
    inc = state.inc
    inc = torch.zeros_like(inc)
    inc.add_(1)
    return state._replace(known=known, status=status, inc=inc)


def run(states, inputs):
    return torch.func.vmap(tick)(states, inputs)
