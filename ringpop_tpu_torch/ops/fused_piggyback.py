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

from typing import List, NamedTuple, Optional

import torch

from ringpop_tpu_torch.ops import _build, toolkit


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
    """Plain PyTorch version of :func:`pb_budget`: full-plane ops.  Also
    takes B stacked clusters (``[B, N, N]`` planes, ``[B, N]`` vectors),
    ``drops`` then per cluster."""
    pb2, active2, content, over = _formula(
        ch_active, ch_pb, hits, nbump[..., None], max_pb[..., None]
    )
    return BudgetOut(
        ch_pb=pb2,
        ch_active=active2,
        content=content if want_content else None,
        drops=over.sum(dim=(-2, -1), dtype=torch.int32),
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
    :func:`pb_budget_plain`.  Inside ``torch.func.vmap`` the call goes
    through the custom op ``ringpop_torch::pb_budget``, whose batching rule
    runs the B clusters' rows as one launch (``drops`` per cluster)."""
    if toolkit.is_batched(ch_active, ch_pb, nbump, max_pb, hits):
        pb2, active2, content, drops = _budget_op(ch_active, ch_pb, nbump, max_pb, hits,
                                                  want_content)
        return BudgetOut(pb2, active2, content if want_content else None,
                         drops.sum(dtype=torch.int32))
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
    if ch_pb.device.type == "cpu":
        return pb_budget_plain(
            ch_active, ch_pb, nbump, max_pb, hits, want_content=want_content
        )
    pb2, active2, content, drops = _launch(ch_active, ch_pb, nbump, max_pb, hits, want_content)
    return BudgetOut(pb2, active2, content, drops.sum(dtype=torch.int32))


def _launch(ch_active, ch_pb, nbump, max_pb, hits, want_content):
    """One launch of ``csrc/pb_budget.cu`` over ``[..., N, N]`` planes: one
    cluster, or B stacked ones whose B * N rows form one pass.  Returns
    ``(ch_pb, ch_active, content or None, per-row drops [..., N])``."""
    dev = ch_pb.device
    shape = tuple(ch_pb.shape)
    n = shape[-1]
    i32 = torch.int32
    _build.check("pb_budget", dev, (
        ("ch_active", ch_active, torch.bool, shape), ("ch_pb", ch_pb, i32, shape),
        ("nbump", nbump, i32, shape[:-1]), ("max_pb", max_pb, i32, shape[:-1]),
    ) + ((("hits", hits, i32, shape),) if hits is not None else ()))
    pb2 = torch.empty(shape, dtype=torch.int32, device=dev)
    active2 = torch.empty(shape, dtype=torch.bool, device=dev)
    content = torch.empty(shape, dtype=torch.bool, device=dev) if want_content else None
    drops = torch.empty(shape[:-1], dtype=torch.int32, device=dev)
    ptrs = [
        _build.ptr(t)
        for t in (ch_active, ch_pb, nbump, max_pb, hits, pb2, active2, content, drops)
    ]
    _build.library().call("ringpop_pb_budget", ptrs, n, drops.numel())
    pb_budget.launches += 1
    return pb2, active2, content, drops


pb_budget.launches = 0


# ---------------------------------------------------------------------------
# the batch axis: B clusters in one launch


def _clusters(ch_active, ch_pb, nbump, max_pb, hits, want_content):
    """B stacked clusters (``[B, N, N]`` planes, ``[B, N]`` vectors): one
    launch on the card, :func:`pb_budget_plain` on the CPU; drops per
    cluster."""
    if ch_pb.device.type == "cpu":
        return tuple(pb_budget_plain(ch_active, ch_pb, nbump, max_pb, hits,
                                     want_content=want_content))
    c = (lambda t: None if t is None else t.contiguous())
    pb2, active2, content, drops = _launch(c(ch_active), c(ch_pb), c(nbump), c(max_pb),
                                           c(hits), want_content)
    return pb2, active2, content, drops.sum(dim=1, dtype=torch.int32)


@torch.library.custom_op(toolkit.LIB + "::pb_budget", mutates_args=())
def _budget_op(
    ch_active: torch.Tensor, ch_pb: torch.Tensor, nbump: torch.Tensor, max_pb: torch.Tensor,
    hits: Optional[torch.Tensor], want_content: bool,
) -> List[torch.Tensor]:
    """One cluster through the op (the wrapper calls it only inside vmap,
    where the rule below runs instead)."""
    outs = _clusters(ch_active[None], ch_pb[None], nbump[None], max_pb[None],
                     None if hits is None else hits[None], want_content)
    return [ch_pb.new_empty(0) if o is None else o[0] for o in outs]


def _budget_rule(info, in_dims, ch_active, ch_pb, nbump, max_pb, hits, want_content):
    b = info.batch_size
    ops = [toolkit.batch_front(t, d, b) for t, d in
           zip((ch_active, ch_pb, nbump, max_pb, hits), in_dims[:5])]
    pb2, active2, content, drops = _clusters(*ops, want_content)
    if content is None:
        return [pb2, active2, ch_pb.new_empty(0), drops], [0, 0, None, 0]
    return [pb2, active2, content, drops], [0, 0, 0, 0]


torch.library.register_vmap(toolkit.LIB + "::pb_budget", _budget_rule)
