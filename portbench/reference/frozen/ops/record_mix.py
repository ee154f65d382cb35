"""Commutative per-member record hash for fast (non-parity) checksums.

Counterpart of ``ringpop_tpu/ops/record_mix.py``: a uint32 hash of a member
record ``(subject, status, incarnation stamp)`` whose per-node sum mod 2^32
discriminates membership views.  Inputs are int32, or int64 for ``inc``
(the device ring's key mixing), whose high word is then hashed too; the
result is the int32 view of the uint32 hash.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.ops.u32 import from_u64, s32, srl


def record_mix(subject, status, inc) -> torch.Tensor:
    """Elementwise record hash over broadcastable int tensors."""
    wide = inc.dtype == torch.int64
    x = subject.to(torch.int32) * s32(0x9E3779B1)
    x = x ^ (status.to(torch.int32) * s32(0x85EBCA77))
    x = x ^ ((from_u64(inc) if wide else inc.to(torch.int32)) * s32(0xC2B2AE3D))
    if wide:
        x = x ^ (from_u64(inc >> 32) * s32(0x27D4EB2F))
    x = x ^ srl(x, 15)
    x = x * s32(0x2C1B3C6D)
    x = x ^ srl(x, 13)
    return x
