"""Fused dissemination budget pass at one site: plain version and CUDA
kernel.

Counterpart of ``ringpop_tpu/ops/fused_piggyback.py`` (lines 46-208).  The
full engine touches the change table's budget planes at four points per
tick (sender select, receiver bump and the two ping-req bumps), each the
same arithmetic: add this round's bump count to ``ch_pb``, retire cells
past the ``15*ceil(log10(n+1))`` bound (dissemination.js:41), emit the
surviving message-content mask and count the drops.

:func:`pb_budget` launches ``csrc/pb_budget.cu`` on CUDA tensors and runs
:func:`pb_budget_plain` on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ringpop_tpu_torch.ops import _build


class BudgetOut(NamedTuple):
    ch_pb: torch.Tensor  # [N, N] int32 — post-bump piggyback counts
    ch_active: torch.Tensor  # [N, N] bool — with over-budget cells retired
    content: Optional[torch.Tensor]  # [N, N] bool — surviving message mask
    drops: torch.Tensor  # [] int32 — cells retired at this site


def _formula(active, pb, hits, nbump_col, max_pb_col):
    """One budget site's exact cell arithmetic.  ``nbump_col`` /
    ``max_pb_col``: [rows, 1] int32; ``hits``: [rows, N] int32 or None."""
    has = nbump_col > 0
    eff = torch.where(
        active & has,
        nbump_col - hits if hits is not None else nbump_col,
        0,
    )
    pb2 = pb + eff
    over = active & (pb2 > max_pb_col)
    return pb2, active & ~over, active & has & ~over, over


def pb_budget_plain(
    ch_active, ch_pb, nbump, max_pb, hits=None, *, want_content: bool = True
) -> BudgetOut:
    """Plain PyTorch version of :func:`pb_budget`: full-plane ops."""
    pb2, active2, content, over = _formula(
        ch_active, ch_pb, hits, nbump[:, None], max_pb[:, None]
    )
    return BudgetOut(
        ch_pb=pb2,
        ch_active=active2,
        content=content if want_content else None,
        drops=over.sum(dtype=torch.int32),
    )


def pb_budget(
    ch_active, ch_pb, nbump, max_pb, hits=None, *, want_content: bool = True
) -> BudgetOut:
    """Fused piggyback budget pass at one dissemination site.

    ``ch_active`` [N, N] bool / ``ch_pb`` [N, N] int32: the change table's
    budget planes; ``nbump`` [N] int32: this site's per-row bump count;
    ``max_pb`` [N] int32: the per-row retirement bound; ``hits``: optional
    [N, N] int32 origin-filter counts subtracted from bumped cells.
    ``want_content=False`` skips the content mask.

    CUDA tensors launch ``csrc/pb_budget.cu``; CPU tensors run
    :func:`pb_budget_plain`."""
    if ch_active.shape != ch_pb.shape or ch_active.ndim != 2:
        raise ValueError(
            "pb_budget wants matching [N, N] planes, got %r / %r"
            % (tuple(ch_active.shape), tuple(ch_pb.shape))
        )
    n = ch_pb.shape[0]
    if tuple(nbump.shape) != (n,) or tuple(max_pb.shape) != (n,):
        raise ValueError(
            "nbump/max_pb must be [N] vectors, got %r / %r"
            % (tuple(nbump.shape), tuple(max_pb.shape))
        )
    dev = ch_pb.device
    if dev.type == "cpu":
        return pb_budget_plain(
            ch_active, ch_pb, nbump, max_pb, hits, want_content=want_content
        )
    i32, nn = torch.int32, (n, n)
    _build.check("pb_budget", dev, (
        ("ch_active", ch_active, torch.bool, nn), ("ch_pb", ch_pb, i32, nn),
        ("nbump", nbump, i32, (n,)), ("max_pb", max_pb, i32, (n,)),
    ) + ((("hits", hits, i32, nn),) if hits is not None else ()))
    pb2 = torch.empty((n, n), dtype=torch.int32, device=dev)
    active2 = torch.empty((n, n), dtype=torch.bool, device=dev)
    content = torch.empty((n, n), dtype=torch.bool, device=dev) if want_content else None
    drops = torch.empty(n, dtype=torch.int32, device=dev)
    ptrs = [
        _build.ptr(t)
        for t in (ch_active, ch_pb, nbump, max_pb, hits, pb2, active2, content, drops)
    ]
    _build.library().call("ringpop_pb_budget", ptrs, n)
    pb_budget.launches += 1
    return BudgetOut(
        ch_pb=pb2,
        ch_active=active2,
        content=content,
        drops=drops.sum(dtype=torch.int32),
    )


pb_budget.launches = 0
