"""BAD: host reads of tensors inside a tick context."""
import torch


def step(x):
    scale = int(x[0])  # finding: host-coerce
    val = float(x.max())  # finding: host-coerce
    flag = bool(x.any())  # finding: host-coerce
    first = x[0].item()  # finding: host-coerce
    rows = x.tolist()  # finding: host-coerce
    return scale + val + flag + first + len(rows)


def run(xs):
    return torch.func.vmap(step)(xs)
