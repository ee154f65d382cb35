"""uint32 arithmetic on int32 storage.

PyTorch's CPU ``uint32`` dtype lacks ``+``, ``>>``, ``<<``, ``>``, ``sum``
and ``scatter_add``, so the port keeps every uint32 value as the int32
tensor with the same bit pattern (``torch.from_numpy(u32).view(torch.int32)``
round-trips exactly).  int32 ``+``, ``-``, ``*``, ``^``, ``|``, ``&`` and
``<<`` already wrap mod 2^32 bit-identically to uint32; this module supplies
the operations where signedness shows: the logical right shift, rotates,
unsigned compares, mod-2^32 sums and the uint32 -> float32 conversion
(through int64, which rounds exactly like numpy's uint32 -> float32).

The CUDA kernels take the same storage as ``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

from ringpop_tpu_torch.ops import toolkit

MASK = 0xFFFFFFFF
_SIGN = -(2**31)


def s32(c: int) -> int:
    """A uint32 constant as the Python int of its int32 bit pattern."""
    c &= MASK
    return c - (1 << 32) if c >= (1 << 31) else c


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift by a constant ``k`` in [0, 31]."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (32 - k)) - 1)


def srl_var(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Logical right shift by a per-element amount in [0, 31]."""
    return from_u64(to_u64(x) >> k.to(torch.int64))


def rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Right rotate by a constant (FarmHash's Rotate32)."""
    if r == 0:
        return x
    return srl(x, r) | (x << (32 - r))


def _flip(x):
    return x ^ _SIGN


def ult(a, b):
    return _flip(a) < _flip(b)


def ule(a, b):
    return _flip(a) <= _flip(b)


def ugt(a, b):
    return _flip(a) > _flip(b)


def uge(a, b):
    return _flip(a) >= _flip(b)


# Byte <-> word reinterpretation.  Outside ``torch.func.vmap`` these are
# dtype views (no copy); a dtype view has no batching rule on every torch
# release, so on functorch ``BatchedTensor``s the same bits come from
# shifts and masks.

def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """[..., 4k] uint8 -> [..., k] int32: little-endian words of the bytes
    (contiguous, 4-byte aligned storage outside vmap).  Inside
    ``torch.func.vmap`` a tensor whose batch axes lead its contiguous
    storage (a batching rule's output) is viewed as well; any other is
    assembled from its bytes."""
    if not toolkit.is_batched(b):
        return b.contiguous().view(torch.int32)
    if toolkit.leads_contiguous(b):
        return toolkit.view_storage(b, lambda t: t.view(torch.int32))
    q = b.reshape(tuple(b.shape[:-1]) + (-1, 4)).to(torch.int64)
    return from_u64(q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24))


def words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """[..., k] int32 -> [..., 4k] uint8: each word's bytes, low first."""
    if not toolkit.is_batched(w):
        return w.contiguous().view(torch.uint8)
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=w.device)
    return ((w[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(tuple(w.shape[:-1]) + (-1,))


def signed_bytes(b: torch.Tensor) -> torch.Tensor:
    """uint8 -> int32 with C ``signed char`` semantics (bytes >= 0x80
    sign-extend)."""
    if not toolkit.is_batched(b):
        return b.view(torch.int8).to(torch.int32)
    return (b.to(torch.int32) ^ 0x80) - 0x80


def to_u64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of each word, as int64."""
    return x.to(torch.int64) & MASK


def from_u64(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 bit patterns of their low 32 bits."""
    return (((x & MASK) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def row_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum mod 2^32 along ``dim`` (int64 accumulate, then wrap)."""
    return from_u64(to_u64(x).sum(dim=dim, dtype=torch.int64))


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32, rounded to nearest like numpy's cast."""
    return to_u64(x).to(torch.float32)


def from_numpy(a, device=None) -> torch.Tensor:
    """A numpy uint32 array -> its int32-view tensor."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """An int32-view tensor -> the numpy uint32 array it stands for."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)
