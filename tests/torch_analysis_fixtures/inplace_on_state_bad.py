"""BAD: writes through the tick's input state."""
import torch


def tick(state, inputs):
    known = state.known
    known[0] = True  # finding: inplace-on-state
    state.status.add_(1)  # finding: inplace-on-state
    torch.add(state.inc, 1, out=state.inc)  # finding: inplace-on-state
    return state


def run(states, inputs):
    return torch.func.vmap(tick)(states, inputs)
