"""Shared pieces of the port's fused ops (frozen): knob resolution, the
packed bool-row bitmask helpers and the batch axis shared by every kernel
wrapper (:func:`is_batched`, :func:`batch_front`): inside
``torch.func.vmap`` a wrapper routes its functorch ``BatchedTensor``
operands through a ``torch.library.custom_op`` of namespace :data:`LIB`
whose ``register_vmap`` rule launches the kernel once for all B clusters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def resolve_impl(
    knob: str,
    requested: str,
    device_type: str,
    *,
    auto: dict,
    allowed: Sequence[str],
) -> str:
    """Resolve a fused-op knob to a concrete impl: anything but "auto" is
    honored after validation against ``allowed``; "auto" is looked up in
    the ``auto`` table by device type ("*" is the fallback row)."""
    if requested != "auto":
        if requested not in allowed:
            raise ValueError(
                "%s must be auto|%s, got %r" % (knob, "|".join(allowed), requested)
            )
        return requested
    return auto.get(device_type, auto["*"])


LIB = "portbench_ref"


def is_batched(*tensors) -> bool:
    """True when any operand is a functorch ``BatchedTensor``: the caller
    runs inside ``torch.func.vmap``, whose tensors have no storage a
    kernel could read."""
    return any(
        isinstance(t, torch.Tensor) and torch._C._functorch.is_batchedtensor(t)
        for t in tensors
    )


def batch_front(t: Optional[torch.Tensor], dim: Optional[int], b: int) -> Optional[torch.Tensor]:
    """A vmap rule's operand with its batch axis first: ``[B, ...]``.  An
    operand that is not batched (``dim`` None) is expanded, a stride-0
    view that costs no copy until a kernel needs it contiguous."""
    if t is None:
        return None
    if dim is None:
        return t.expand(b, *t.shape)
    return t.movedim(dim, 0)


def packed_width(n_cols: int) -> int:
    """Words per row of a :func:`pack_bool_rows` bitmask."""
    return -(-n_cols // 32)


def pack_bool_rows(mask: torch.Tensor) -> torch.Tensor:
    """[..., N, M] bool -> [..., N, ceil(M/32)] int32 (uint32) row bitmask,
    bit c%32 of word c//32 = mask[..., c]."""
    pad = (-mask.shape[-1]) % 32
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    w = mask.reshape(mask.shape[:-1] + (-1, 32)).to(torch.int64)
    bits = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=mask.device),
        torch.arange(32, dtype=torch.int64, device=mask.device),
    )
    packed = (w * bits).sum(dim=-1, dtype=torch.int64)  # distinct bits: the sum is the OR
    return ((packed ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 (uint32) word."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF
