"""Suppression handling: the host-coerce violations of the bad fixture,
silenced per line, except one deliberately mis-named suppression that
must NOT silence its finding."""
import torch


def step(x):
    scale = int(x[0])  # torchgate: ignore[host-coerce]
    flag = bool(x.any())  # torchgate: ignore
    total = float(x.sum(dtype=torch.float32))  # torchgate: ignore[implicit-dtype]
    wrapped = int(
        x[1]
    )  # torchgate: ignore[host-coerce] — comment on the statement's last line
    return scale + flag + total + wrapped


def host_table(n):  # torchgate: host
    # a host helper: called by step's context, exempt from its rules
    return [int(v) for v in torch.arange(n, dtype=torch.int32)]


def uses_table(x):
    return x + host_table(x.shape[0])[0]


def run(xs):
    return torch.func.vmap(step)(xs), torch.func.vmap(uses_table)(xs)
