"""The FarmHash32 long-string block loop: plain version and CUDA kernel.

Counterpart of the two Pallas entries of ``ringpop_tpu/ops/pallas_farmhash.py``,
``block_loop`` (kernel ``_kernel``, :36) and its gridless form
``block_loop_nogrid`` (kernel ``_nogrid_kernel``, :429).  farmhashmk's
long-string path chains the carries ``(h, g, f)`` through one mixing round
per 20-byte block::

    nh = h + a;  ng = g + b;  nf = f + c
    nh = mur(d, nh) + e;  ng = mur(c, ng) + a;  nf = mur(b + e*C1, nf) + d
    nf += ng;  ng += nf

with the round applied only while ``i < iters[row]``.  The rounds of a row
are one sequential chain; rows are independent.

:func:`block_loop` launches ``csrc/block_loop.cu`` on CUDA tensors and runs
:func:`block_loop_plain` on CPU tensors.  Both take JAX's signature:
``[B]`` carries, ``[B, I, 5]`` blocks and ``[B]`` trip counts, returning
``(h, g, f)``.  The kernel also takes a ``[B, I, 5]`` view whose rows are
``row_stride >= 5*I`` words apart (strides ``(row_stride, 5, 1)``), so the
packed word view of a byte matrix feeds it without a copy.

uint32 values are int32 bit patterns (:mod:`ringpop_tpu_torch.ops.u32`).
"""

from __future__ import annotations

import torch

from ringpop_tpu_torch.ops import _build
from ringpop_tpu_torch.ops.farmhash import C1, _mur


def _round(h, g, f, a, b, c, d, e):
    nh = h + a
    ng = g + b
    nf = f + c
    nh = _mur(d, nh) + e
    ng = _mur(c, ng) + a
    nf = _mur(b + e * C1, nf) + d
    nf = nf + ng
    ng = ng + nf
    return nh, ng, nf


def block_loop_plain(h0, g0, f0, blocks, iters):
    """Plain PyTorch version of :func:`block_loop`: the masked loop over
    the block axis, stopping after the longest row's last round (later
    rounds are inactive on every row)."""
    B, n_iter, _ = blocks.shape
    h, g, f = h0, g0, f0
    steps = min(n_iter, int(iters.max())) if B else 0
    for i in range(steps):
        active = i < iters
        a, b, c, d, e = blocks[:, i].unbind(1)
        nh, ng, nf = _round(h, g, f, a, b, c, d, e)
        h = torch.where(active, nh, h)
        g = torch.where(active, ng, g)
        f = torch.where(active, nf, f)
    return h, g, f


def _check_blocks(blocks: torch.Tensor, B: int, n_iter: int, dev) -> int:
    """Validate the block operand; returns its row stride in words."""
    what = "block_loop: blocks"
    if blocks.device != dev:
        raise ValueError("%s is on %s, expected %s" % (what, blocks.device, dev))
    if blocks.dtype != torch.int32:
        raise ValueError("%s has dtype %s, expected torch.int32" % (what, blocks.dtype))
    if tuple(blocks.shape) != (B, n_iter, 5):
        raise ValueError("%s has shape %s, expected %s"
                         % (what, tuple(blocks.shape), (B, n_iter, 5)))
    rs, s1, s2 = blocks.stride()
    if s2 != 1 or (n_iter > 1 and s1 != 5) or (B > 1 and rs < 5 * n_iter):
        raise ValueError(
            "%s must have strides (row_stride >= %d, 5, 1), got %s"
            % (what, 5 * n_iter, blocks.stride())
        )
    return rs if B > 1 else 5 * n_iter


def block_loop(h0, g0, f0, blocks, iters):
    """The farmhashmk block loop: ``h0/g0/f0`` [B] int32 (uint32) carries
    after the tail mixes, ``blocks`` [B, I, 5] int32 (uint32) aligned words
    (contiguous, or rows ``row_stride`` words apart), ``iters`` [B] int32
    per-row trip counts.  Returns ``(h, g, f)`` [B] int32 (uint32).

    A CUDA tensor launches ``csrc/block_loop.cu``; a CPU tensor runs
    :func:`block_loop_plain`."""
    if blocks.ndim != 3 or blocks.shape[2] != 5:
        raise ValueError("block_loop wants [B, I, 5] blocks, got %r" % (tuple(blocks.shape),))
    if blocks.device.type == "cpu":
        return block_loop_plain(h0, g0, f0, blocks, iters)
    B, n_iter, _ = blocks.shape
    dev = blocks.device
    i32 = torch.int32
    _build.check("block_loop", dev, (
        ("h0", h0, i32, (B,)), ("g0", g0, i32, (B,)), ("f0", f0, i32, (B,)),
        ("iters", iters, i32, (B,)),
    ))
    row_stride = _check_blocks(blocks, B, n_iter, dev)
    h = torch.empty_like(h0)
    g = torch.empty_like(g0)
    f = torch.empty_like(f0)
    ptrs = [_build.ptr(t) for t in (h0, g0, f0, blocks, iters, h, g, f)]
    _build.library().call("ringpop_block_loop", ptrs, B, n_iter, row_stride)
    block_loop.launches += 1
    return h, g, f


block_loop.launches = 0
