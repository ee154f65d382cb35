"""No kernels in the reference: every launch site raises.

The frozen engine is run with every knob on its plain PyTorch version
(``fused_tick="plain"``, ``fused_exchange="plain"``, ``hash_impl="plain"``),
so nothing here is reached on a sound path; a call that would launch a
CUDA kernel is a fault of the reference's set-up and stops it.
"""

from __future__ import annotations

from typing import Optional

import torch


def library():
    raise RuntimeError("the reference runs no CUDA kernel: set every knob to its plain version")


def ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def check(name: str, device, operands) -> None:
    raise RuntimeError("%s: the reference runs no CUDA kernel" % name)
