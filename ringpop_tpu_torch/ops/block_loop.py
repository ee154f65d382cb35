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

from typing import List

import torch

from ringpop_tpu_torch.ops import _build, toolkit
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
    every round of the block axis.  The rounds past a row's trip count are
    inactive, so bit-neutral; the trip counts are never read on the host,
    so the loop costs no host read on any device, inside vmap or not."""
    B, n_iter, _ = blocks.shape
    h, g, f = h0, g0, f0
    for i in range(n_iter if B else 0):
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
    :func:`block_loop_plain`.  Inside ``torch.func.vmap`` the call goes
    through the custom op ``ringpop_torch::block_loop``, whose batching
    rule runs the rows of every cluster in one launch."""
    if toolkit.is_batched(h0, g0, f0, blocks, iters):
        return tuple(_loop_op(h0, g0, f0, blocks, iters))
    if blocks.ndim != 3 or blocks.shape[2] != 5:
        raise ValueError("block_loop wants [B, I, 5] blocks, got %r" % (tuple(blocks.shape),))
    if blocks.device.type == "cpu":
        return block_loop_plain(h0, g0, f0, blocks, iters)
    return _launch(h0, g0, f0, blocks, iters)


def _launch(h0, g0, f0, blocks, iters):
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
    _build.library().call("ringpop_block_loop", dev, ptrs, B, n_iter, row_stride)
    block_loop.launches += 1
    return h, g, f


block_loop.launches = 0


# ---------------------------------------------------------------------------
# the batch axis: the rows of B clusters in one launch


def _clusters(h0, g0, f0, blocks, iters):
    """C clusters' ``[C, R]`` carries and ``[C, R, I, 5]`` blocks as one
    ``[C * R]`` row set.  The blocks keep their row stride when the
    clusters' rows are evenly spaced (a batched word view of checksum rows),
    else they are copied contiguous."""
    c, r, n_iter, _ = blocks.shape
    flat = [t.reshape(-1).contiguous() for t in (h0, g0, f0, iters)]
    s_c, s_r, s_i, s_w = blocks.stride()
    if s_w == 1 and (n_iter <= 1 or s_i == 5) and (c <= 1 or s_c == r * s_r) and s_r >= 5 * n_iter:
        rows = blocks.as_strided((c * r, n_iter, 5), (s_r, 5, 1))
    else:
        rows = blocks.contiguous().reshape(c * r, n_iter, 5)
    if blocks.device.type == "cpu":
        out = block_loop_plain(flat[0], flat[1], flat[2], rows, flat[3])
    else:
        out = _launch(flat[0], flat[1], flat[2], rows, flat[3])
    return [t.reshape(c, r) for t in out]


@torch.library.custom_op(toolkit.LIB + "::block_loop", mutates_args=())
def _loop_op(
    h0: torch.Tensor, g0: torch.Tensor, f0: torch.Tensor, blocks: torch.Tensor,
    iters: torch.Tensor,
) -> List[torch.Tensor]:
    """One cluster's rows through the op (the wrapper calls it only inside
    vmap, where the rule below runs instead)."""
    return [t[0] for t in _clusters(h0[None], g0[None], f0[None], blocks[None], iters[None])]


def _loop_rule(info, in_dims, *args):
    b = info.batch_size
    out = _clusters(*(toolkit.batch_front(t, d, b) for t, d in zip(args, in_dims)))
    return out, [0, 0, 0]


torch.library.register_vmap(toolkit.LIB + "::block_loop", _loop_rule)
