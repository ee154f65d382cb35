"""Fused membership-update application at one site: plain version and
CUDA kernel.

Counterpart of ``ringpop_tpu/ops/fused_apply.py`` (lines 65-409).  The full
engine applies ``Member.evaluateUpdate`` at six points per tick (ping
receive, responses, three ping-req legs, suspicion expiry).  One pass per
site computes the SWIM precedence gate (:func:`overrides`), refute
detection, the change-table write and the suspicion starts/stops with the
deadline stamp folded in, and returns reductions instead of dense masks:
the per-row applied OR, an opt-in per-row count summed to a scalar, the
opt-in refute diagonal, an opt-in packed ``[N, ceil(N/32)]`` applied-union
OR-accumulated in-pass, and the dense applied mask only under
``want_masks``.

A shard tile: every plane may hold rows ``[lo, lo + R)`` of the ``[N, N]``
cluster (``lo=0``, ``R = N`` is the whole plane).  ``lo`` enters only the
diagonal test (the row's node id), so a tile gives those rows of the
whole-plane call.

:func:`apply_updates` launches ``csrc/apply_updates.cu`` on CUDA tensors
and runs :func:`apply_updates_plain` on CPU tensors.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from portbench.reference.frozen.ops import _build, toolkit

# status codes: rank order IS override priority at equal incarnation
ALIVE, SUSPECT, FAULTY, LEAVE = 0, 1, 2, 3


def overrides(u_status, u_inc, c_status, c_inc):
    """The exact SWIM precedence table (member.js:171-202), elementwise."""
    alive_ov = (u_status == ALIVE) & (u_inc > c_inc)
    suspect_ov = (u_status == SUSPECT) & (
        ((c_status == SUSPECT) & (u_inc > c_inc))
        | ((c_status == FAULTY) & (u_inc > c_inc))
        | ((c_status == ALIVE) & (u_inc >= c_inc))
    )
    faulty_ov = (u_status == FAULTY) & (
        ((c_status == SUSPECT) & (u_inc >= c_inc))
        | ((c_status == FAULTY) & (u_inc > c_inc))
        | ((c_status == ALIVE) & (u_inc >= c_inc))
    )
    leave_ov = (u_status == LEAVE) & (c_status != LEAVE) & (u_inc >= c_inc)
    return alive_ov | suspect_ov | faulty_ov | leave_ov


class ApplyState(NamedTuple):
    """The ten per-(observer, subject) planes an application site reads
    and writes."""

    known: torch.Tensor  # [N, N] bool
    status: torch.Tensor  # [N, N] int32
    inc: torch.Tensor  # [N, N] int32
    ch_active: torch.Tensor  # [N, N] bool
    ch_status: torch.Tensor  # [N, N] int32
    ch_inc: torch.Tensor  # [N, N] int32
    ch_source: torch.Tensor  # [N, N] int32
    ch_source_inc: torch.Tensor  # [N, N] int32
    ch_pb: torch.Tensor  # [N, N] int32
    susp_deadline: torch.Tensor  # [N, N] int32


# the kernel's fifteen [N, N] operands: the state planes, then the updates
_OPERANDS = ApplyState._fields + ("recv_mask", "u_status", "u_inc", "u_source", "u_source_inc")
_OPERAND_DTYPES = (
    torch.bool, torch.int32, torch.int32, torch.bool, torch.int32,
    torch.int32, torch.int32, torch.int32, torch.int32, torch.int32,
    torch.bool, torch.int32, torch.int32, torch.int32, torch.int32,
)


class ApplyOut(NamedTuple):
    state: ApplyState
    union: Optional[torch.Tensor]  # [N, W] int32 (uint32) packed union
    applied: Optional[torch.Tensor]  # [N, N] bool — only under want_masks
    applied_rows: torch.Tensor  # [N] bool — per-row applied OR
    applied_count: Optional[torch.Tensor]  # [] int32 — opt-in
    refute_diag: Optional[torch.Tensor]  # [N] bool — opt-in


def _formula(st: ApplyState, recv_mask, u_status, u_inc, u_source, u_source_inc, now, deadline,
             lo: int = 0):
    """One application site's exact cell arithmetic over ``[R, N]`` tiles
    of rows ``[lo, lo + R)`` (or ``[B, R, N]`` with ``now``/``deadline`` of
    shape ``[B, 1, 1]``)."""
    rows, n = st.status.shape[-2:]
    ids = torch.arange(n, dtype=torch.int32, device=st.status.device)
    is_self = ids[None, :] == ids[lo:lo + rows, None]

    refute = recv_mask & is_self & ((u_status == SUSPECT) | (u_status == FAULTY))
    eff_status = torch.where(refute, ALIVE, u_status)
    eff_inc = torch.where(refute, now, u_inc)

    new_member = recv_mask & ~st.known
    gate = recv_mask & (
        refute | new_member | overrides(eff_status, eff_inc, st.status, st.inc)
    )

    status = torch.where(gate, eff_status, st.status)
    inc = torch.where(gate, eff_inc, st.inc)
    start_t = gate & (status == SUSPECT) & ~is_self
    stop_t = gate & (status != SUSPECT)
    out = ApplyState(
        known=st.known | new_member,
        status=status,
        inc=inc,
        ch_active=st.ch_active | gate,
        ch_status=torch.where(gate, status, st.ch_status),
        ch_inc=torch.where(gate, inc, st.ch_inc),
        ch_source=torch.where(gate, u_source, st.ch_source),
        ch_source_inc=torch.where(gate, u_source_inc, st.ch_source_inc),
        ch_pb=torch.where(gate, 0, st.ch_pb),
        # starts and stops are disjoint (status == SUSPECT vs !=)
        susp_deadline=torch.where(
            start_t, deadline, torch.where(stop_t, -1, st.susp_deadline)
        ),
    )
    return out, gate, refute


def _as_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def apply_updates_plain(
    st: ApplyState,
    recv_mask,
    u_status,
    u_inc,
    u_source,
    u_source_inc,
    now,
    deadline,
    union=None,
    *,
    want_masks: bool = False,
    want_count: bool = False,
    want_refute: bool = True,
    lo: int = 0,
) -> ApplyOut:
    """Plain PyTorch version of :func:`apply_updates`: full-plane ops.
    Also takes B stacked clusters: ``[B, R, N]`` planes with ``[B]``
    stamps, ``applied_count`` then per cluster."""
    dev = st.status.device
    now, deadline = (_as_i32(x, dev) for x in (now, deadline))
    new_st, gate, refute = _formula(
        st, recv_mask, u_status, u_inc, u_source, u_source_inc,
        now.reshape(now.shape + (1, 1)), deadline.reshape(deadline.shape + (1, 1)), lo,
    )
    return ApplyOut(
        state=new_st,
        union=None if union is None else union | toolkit.pack_bool_rows(gate),
        applied=gate if want_masks else None,
        applied_rows=gate.any(dim=-1),
        applied_count=gate.sum(dim=(-2, -1), dtype=torch.int32) if want_count else None,
        refute_diag=refute.any(dim=-1) if want_refute else None,
    )


def _validate(st: ApplyState, union, lo: int) -> None:
    if len({tuple(p.shape) for p in st}) != 1:
        raise ValueError("ApplyState planes must share one [R, N] shape")
    if st.status.ndim != 2:
        raise ValueError(
            "apply_updates wants [R, N] planes, got %r" % (tuple(st.status.shape),)
        )
    rows, n = st.status.shape
    if not 0 <= lo <= n - rows:
        raise ValueError(
            "rows [%d, %d) of the tile lie outside the %d-node cluster" % (lo, lo + rows, n)
        )
    if union is not None and tuple(union.shape) != (rows, toolkit.packed_width(n)):
        raise ValueError(
            "union must be a packed [R, ceil(N/32)] bitmask, got %r" % (tuple(union.shape),)
        )


def apply_updates(
    st: ApplyState,
    recv_mask,
    u_status,
    u_inc,
    u_source,
    u_source_inc,
    now,
    deadline,
    union=None,
    *,
    want_masks: bool = False,
    want_count: bool = False,
    want_refute: bool = True,
    lo: int = 0,
) -> ApplyOut:
    """Fused membership-update application at one site.

    ``st``: the ten state planes; ``recv_mask`` [N, N] bool + the four
    ``u_*`` [N, N] int32 update planes (consumed only under
    ``recv_mask``); ``now`` / ``deadline``: int32 scalars (a Python int
    or a 0-d tensor) — this tick's incarnation stamp and suspicion
    deadline; ``union``: optional [N, ceil(N/32)] int32 packed running
    union (None skips the accumulate and returns None).  ``want_masks``
    adds the dense applied mask; ``want_count`` / ``want_refute`` opt into
    the applied-cell count and refute diagonal.  Every ``[N, ...]`` operand
    may be a shard tile of rows ``[lo, lo + R)`` (``[R, ...]``).

    CUDA tensors launch ``csrc/apply_updates.cu``; CPU tensors run
    :func:`apply_updates_plain`.  Inside ``torch.func.vmap`` the call goes
    through the custom op ``portbench_ref::apply_updates``, whose batching
    rule launches the kernel once for all B clusters (per-cluster stamps;
    ``applied_count`` then comes back per cluster)."""
    upd = (recv_mask, u_status, u_inc, u_source, u_source_inc)
    if toolkit.is_batched(*st, *upd, now, deadline, union):
        dev = st.status.device
        outs = _apply_op(*st, *upd, _as_i32(now, dev), _as_i32(deadline, dev), union,
                         want_masks, want_count, want_refute, lo)
        return _apply_out(outs, union, want_masks, want_count, want_refute)
    dev = st.status.device
    if dev.type == "cpu":
        _validate(st, union, lo)
        return apply_updates_plain(
            st, recv_mask, u_status, u_inc, u_source, u_source_inc, now, deadline,
            union, want_masks=want_masks, want_count=want_count, want_refute=want_refute,
            lo=lo,
        )
    outs = _launch(tuple(st) + upd, _stamp(now, dev), _stamp(deadline, dev), union,
                   want_masks, want_count, want_refute, clusters=None, lo=lo)
    return _apply_out(outs, union, want_masks, want_count, want_refute)


def _apply_out(outs, union, want_masks, want_count, want_refute) -> ApplyOut:
    """The fifteen outputs of a launch (or of the custom op, whose absent
    outputs are empty tensors) as an ``ApplyOut``; the applied counts
    (per row from a launch, per cluster from the plain version) summed,
    per cluster inside vmap."""
    return ApplyOut(
        state=ApplyState(*outs[:10]),
        union=outs[10] if union is not None else None,
        applied=outs[11] if want_masks else None,
        applied_rows=outs[12],
        applied_count=outs[13].sum(dtype=torch.int32) if want_count else None,
        refute_diag=outs[14] if want_refute else None,
    )


def _launch(planes, now_t, deadline_t, union, want_masks, want_count, want_refute, clusters,
            lo: int = 0):
    """One launch of ``csrc/apply_updates.cu`` over one cluster's ``[R, N]``
    tiles of rows ``[lo, lo + R)`` (``clusters`` None) or ``clusters``
    stacked ``[B, R, N]`` ones (``now_t``/``deadline_t`` then ``[B]``).
    Returns the fifteen outputs in the op's order; an output that was not
    asked for is None."""
    dev = planes[1].device
    lead = () if clusters is None else (clusters,)
    rows, n = planes[1].shape[-2:]
    if not 0 <= lo <= n - rows:
        raise ValueError(
            "rows [%d, %d) of the tile lie outside the %d-node cluster" % (lo, lo + rows, n)
        )
    words = toolkit.packed_width(n)
    nn = lead + (rows, n)
    _build.check("apply_updates", dev, zip(_OPERANDS, planes, _OPERAND_DTYPES, (nn,) * 15))
    if union is not None:
        _build.check("apply_updates", dev, (("union", union, torch.int32, lead + (rows, words)),))
    if clusters is not None:
        _build.check("apply_updates", dev, (
            ("now", now_t, torch.int32, lead), ("deadline", deadline_t, torch.int32, lead),
        ))
    # the outputs in two allocations: the eight int32 planes and the byte
    # planes (known, ch_active and, under want_masks, the applied mask)
    p32 = torch.empty((8,) + nn, dtype=torch.int32, device=dev).unbind(0)
    p8 = torch.empty((3 if want_masks else 2,) + nn, dtype=torch.bool, device=dev).unbind(0)
    outs = (p8[0], p32[0], p32[1], p8[1], *p32[2:])
    applied = p8[2] if want_masks else None
    new_union = (torch.empty(lead + (rows, words), dtype=torch.int32, device=dev)
                 if union is not None else None)
    applied_rows = torch.empty(lead + (rows,), dtype=torch.bool, device=dev)
    count = torch.empty(lead + (rows,), dtype=torch.int32, device=dev) if want_count else None
    refute = torch.empty(lead + (rows,), dtype=torch.bool, device=dev) if want_refute else None
    # the stamps stay on the device: the kernel reads them (cluster b's
    # at index b), so no host sync is needed to launch
    ptr = _build.ptr
    _build.library().call(
        "ringpop_apply_updates", dev,
        (*(t.data_ptr() for t in planes), ptr(union), now_t.data_ptr(), deadline_t.data_ptr(),
         *(t.data_ptr() for t in outs), ptr(new_union), ptr(applied), applied_rows.data_ptr(),
         ptr(count), ptr(refute)),
        n, words, 1 if clusters is None else clusters, rows, lo,
    )
    apply_updates.launches += 1
    return (*outs, new_union, applied, applied_rows, count, refute)


def _stamp(x, dev) -> torch.Tensor:
    """An int32 0-d tensor on ``dev``: ``x`` itself when it already is one."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32 and x.dim() == 0 and x.device == dev:
        return x
    return _as_i32(x, dev).reshape(())


apply_updates.launches = 0


# ---------------------------------------------------------------------------
# the batch axis: B clusters in one launch


def _clusters(planes, now, deadline, union, want_masks, want_count, want_refute, lo=0):
    """B stacked clusters (``[B, R, N]`` planes, ``[B]`` stamps): one
    kernel launch on the card, :func:`apply_updates_plain` on the CPU.
    Returns the fifteen outputs in the op's order; absent ones are None."""
    if now.device.type == "cpu":
        o = apply_updates_plain(ApplyState(*planes[:10]), *planes[10:], now, deadline, union,
                                want_masks=want_masks, want_count=want_count,
                                want_refute=want_refute, lo=lo)
        return (*o.state, o.union, o.applied, o.applied_rows, o.applied_count, o.refute_diag)
    return _launch(tuple(t.contiguous() for t in planes), now.contiguous(),
                   deadline.contiguous(), None if union is None else union.contiguous(),
                   want_masks, want_count, want_refute, clusters=now.shape[0], lo=lo)


def _filled(outs, ref: torch.Tensor):
    """A custom op returns tensors only: absent outputs become empty ones."""
    return [ref.new_empty(0) if o is None else o for o in outs]


@torch.library.custom_op(toolkit.LIB + "::apply_updates", mutates_args=())
def _apply_op(
    known: torch.Tensor, status: torch.Tensor, inc: torch.Tensor, ch_active: torch.Tensor,
    ch_status: torch.Tensor, ch_inc: torch.Tensor, ch_source: torch.Tensor,
    ch_source_inc: torch.Tensor, ch_pb: torch.Tensor, susp_deadline: torch.Tensor,
    recv_mask: torch.Tensor, u_status: torch.Tensor, u_inc: torch.Tensor,
    u_source: torch.Tensor, u_source_inc: torch.Tensor, now: torch.Tensor,
    deadline: torch.Tensor, union: Optional[torch.Tensor], want_masks: bool,
    want_count: bool, want_refute: bool, lo: int,
) -> List[torch.Tensor]:
    """One cluster through the op: the kernel on the card, the plain
    version on the CPU (the wrapper calls the op only inside vmap, where
    the rule below runs instead)."""
    planes = (known, status, inc, ch_active, ch_status, ch_inc, ch_source, ch_source_inc,
              ch_pb, susp_deadline, recv_mask, u_status, u_inc, u_source, u_source_inc)
    outs = _clusters(tuple(t[None] for t in planes), now.reshape(1), deadline.reshape(1),
                     None if union is None else union[None], want_masks, want_count,
                     want_refute, lo)
    return _filled([None if o is None else o[0] for o in outs], status)


def _apply_rule(info, in_dims, *args):
    b = info.batch_size
    planes = tuple(toolkit.batch_front(t, d, b) for t, d in zip(args[:15], in_dims[:15]))
    now, deadline = (toolkit.batch_front(t, d, b).reshape(b) for t, d in zip(args[15:17], in_dims[15:17]))
    union = toolkit.batch_front(args[17], in_dims[17], b)
    outs = _clusters(planes, now, deadline, union, *args[18:])
    return _filled(outs, planes[1]), [None if o is None else 0 for o in outs]


torch.library.register_vmap(toolkit.LIB + "::apply_updates", _apply_rule)
