"""Device-side protocol flight recorder — the in-tick event emitter.

Counterpart of ``ringpop_tpu/models/sim/flight.py``, held against it bit
for bit (tests/test_torch_flight.py).  A fixed-capacity buffer of int32
event records (layout: ``obs/events.py``) plus a write head and a drop
counter, carried as ordinary ``SimState`` fields and appended to at the
end of the tick from the same masks that drove it — nothing in the
protocol reads them, so the recorder is trajectory-neutral.  On overflow
new events are dropped and counted, never overwritten.

Write mechanics, as in the JAX op: each emission flattens a mask (row
major), ranks the selected lanes with a cumulative sum, and scatters the
records at ``head + rank``; lanes past the capacity, and masked lanes, go
to a scratch row ``cap`` that is sliced off.  No ``nonzero`` and no
boolean indexing: ``head`` and ``drops`` stay 0-d tensors on the device,
and the tick reads nothing back to the host.  One copy of the buffer is
made per tick (the ``cap + 1``-row scratch); the appends write into it.

On a shard mesh (``parallel.mesh.ShardedSim``) the buffer is cut into
capacity blocks, ``np.array_split``'s: shard s holds rows
:func:`capacity_block` of it, and the buffer's order stays the single
device's — global row major, one emission after another, so append k of
every shard comes before append k+1 of any.  A shard ranks its own lanes,
and one ``gather`` of every shard's ``[EMISSIONS]`` emission counts gives
each emission's total and the shard's offset in it (an exclusive prefix
over the shards before it): shard s writes append k at ``head_k +
offset_{k,s} + rank``.  One more ``gather`` of every shard's candidate
lanes (global position and record) lets each shard write the records
that land in its block into its ``block + 1``-row scratch.  ``ev_head``
and ``ev_drops`` are replicated; nothing is read on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ringpop_tpu_torch.obs import events as ev

ALIVE, SUSPECT, FAULTY = 0, 1, 2


def max_events_per_tick(n: int, ping_req_size: int = 3) -> int:
    """Exact upper bound on the records one tick can append — the sum of
    every emission mask's lane count in :func:`record_tick_events`."""
    return 3 * n * n + (7 + ping_req_size) * n


def init_recorder_fields(n: int, capacity: int, device="cpu"):
    """(ev_buf, ev_head, ev_drops, first_heard) initial values.
    ``first_heard[i, j]`` is the tick at which observer i first adopted
    j's current rumor (-1 = only what it was born with; the self view is
    born at tick 0)."""
    eye = np.eye(n, dtype=bool)
    i32 = dict(dtype=torch.int32, device=device)
    return (
        torch.zeros((capacity, ev.RECORD_WIDTH), **i32),
        torch.zeros((), **i32),
        torch.zeros((), **i32),
        torch.as_tensor(np.where(eye, 0, -1).astype(np.int32), device=device),
    )


# the appends of one tick (:func:`record_tick_events`): pings, status
# changes, suspect and faulty verdicts, two full-sync kinds, four refute
# phases, joins
EMISSIONS = 11


def capacity_block(capacity: int, shards: int, index: int) -> tuple:
    """Rows ``[lo, hi)`` of a ``capacity``-row event buffer that shard
    ``index`` of ``shards`` holds: ``np.array_split``'s blocks (the first
    ``capacity % shards`` blocks one row longer)."""
    q, r = divmod(capacity, shards)
    lo = index * q + min(index, r)
    return lo, lo + q + (1 if index < r else 0)


class _Appender:
    """The buffer of one tick: a ``rows + 1``-row scratch (row ``rows``
    takes the dropped lanes) that every append writes into.  Alone the
    scratch is the whole buffer; on a mesh it is the shard's capacity
    block ``[block_lo, block_lo + rows)`` of a ``capacity``-row buffer,
    and the appends only collect their lanes (``pending``) until
    :meth:`place` writes every shard's records into it."""

    def __init__(self, buf, head, drops, capacity=None, block_lo=None):
        self.rows = buf.shape[0]
        self.cap = self.rows if capacity is None else capacity
        self.block_lo = block_lo
        self.pending = None if block_lo is None else []
        self.ext = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))])
        self.head = head
        self.drops = drops

    def append(self, mask, tick, kind, observer, subject, old_status, new_status, inc, aux,
               offset=None, total=None):
        """Masked append of up to M candidate events, in lane order.  On a
        mesh, ``offset`` is the lanes the shards before this one selected
        and ``total`` every shard's selected lanes."""
        mask = mask.reshape(-1)
        m = mask.shape[0]
        dev = mask.device
        mask_i = mask.to(torch.int32)
        if total is None:
            total = mask_i.sum(dtype=torch.int32)
        rank = torch.cumsum(mask_i, 0, dtype=torch.int32) - 1
        pos = self.head + rank if offset is None else self.head + offset + rank
        tgt = torch.where(mask & (pos < self.cap), pos, self.cap)

        def lane(v):
            # a Python constant is filled on the device (no host copy)
            if isinstance(v, int):
                return torch.full((m,), v, dtype=torch.int32, device=dev)
            v = v.to(torch.int32)
            return v.reshape(1).expand(m) if v.dim() == 0 else v.reshape(m)

        rec = torch.stack(
            [lane(tick), lane(kind), lane(observer), lane(subject), lane(old_status),
             lane(new_status), lane(inc), lane(aux)],
            dim=1,
        )
        if self.pending is None:
            self.ext.index_put_((tgt.to(torch.int64),), rec)
        else:
            self.pending.append(torch.cat([tgt[:, None], rec], dim=1))
        end = self.head + total
        self.drops = self.drops + (end - self.cap).clamp(min=0)
        self.head = end.clamp(max=self.cap)

    def collected(self) -> torch.Tensor:
        """This shard's candidate lanes, ``[M, 1 + RECORD_WIDTH]``: each
        lane's global position (``capacity`` = dropped) and record."""
        return torch.cat(self.pending)

    def place(self, lanes: torch.Tensor) -> None:
        """Write the lanes (every shard's :meth:`collected`) whose position
        falls in this shard's block; the rest go to the scratch row."""
        at = lanes[:, 0] - self.block_lo
        at = torch.where((at >= 0) & (at < self.rows), at, self.rows)
        self.ext.index_put_((at.to(torch.int64),), lanes[:, 1:])

    def result(self):
        return self.ext[: self.rows], self.head, self.drops


class TickEventMasks(NamedTuple):
    """Everything the end-of-tick emission needs, from the phase outputs
    (the masks that drove the trajectory)."""

    valid_send: torch.Tensor  # [N] bool
    target: torch.Tensor  # [N] int32
    delivered: torch.Tensor  # [N] bool
    applied_ping: torch.Tensor  # [N, N] bool
    applied_resp: torch.Tensor  # [N, N] bool
    applied_pr: torch.Tensor  # [N, N] bool
    ja_applied: torch.Tensor  # [N, N] bool
    applied_sus: torch.Tensor  # [N, N] bool
    applied_faulty: torch.Tensor  # [N, N] bool
    joined: torch.Tensor  # [N] bool
    full_sync: torch.Tensor  # [N] bool (ping path, indexed by sender)
    fs_rec_rows: torch.Tensor  # [N] int32 — records per ping-path full sync
    pr_fs_mask: torch.Tensor  # [N, K] bool — ping-req full syncs
    pr_fs_recs: torch.Tensor  # [N, K] int32 — records per ping-req full sync
    pr_sel: torch.Tensor  # [N, K] int — selected intermediaries
    refute_recv: torch.Tensor  # [N] bool — self-refutes in the receive phase
    refute_resp: torch.Tensor  # [N] bool — ... in the response phase
    refute_prm: torch.Tensor  # [N] bool — ... at the ping-req intermediaries leg
    refute_prr: torch.Tensor  # [N] bool — ... at the ping-req responses leg
    revived: torch.Tensor  # [N] bool — process restarted (views reset)
    left: torch.Tensor  # [N] bool — graceful-leave self-write this tick
    rejoined: torch.Tensor  # [N] bool — rejoin-of-left self-write this tick


def record_tick_events(sh, state, tick, prev_known, prev_status, masks: TickEventMasks,
                       n: int, capacity: int):
    """Append this tick's events (a shard body's generator); returns the
    state with new ``ev_*`` and ``first_heard`` fields.  Emission order,
    as in the JAX op: pings, status changes, suspect and faulty verdicts,
    full syncs (ping path, then ping-req path), refutes (four phases),
    joins.  ``sh`` is the shard (``engine_scalable.Solo`` alone): the
    masks and the ``[N, ...]`` planes hold its rows ``[sh.lo, sh.lo +
    rows)`` of the ``n``-node cluster, ``state.ev_buf`` its capacity block
    of the ``capacity``-row buffer.  Alone it yields nothing; on a mesh it
    yields two ``gather``s (module docstring)."""
    rows = prev_known.shape[0]
    lo = sh.lo
    dev = prev_known.device
    ids = torch.arange(lo, lo + rows, dtype=torch.int32, device=dev)
    subjects = torch.arange(n, dtype=torch.int32, device=dev)
    row = ids[:, None].expand(rows, n).reshape(-1)
    col = subjects[None, :].expand(rows, n).reshape(-1)
    is_self = ids[:, None] == subjects[None, :]
    i32 = torch.int32
    target = masks.target.clamp(0, n - 1)

    # view changes: the union of every apply mask, the phases in aux;
    # old view = the tick-start view (-1 unknown), new = end of tick
    join_learned = masks.joined[:, None] & state.known & ~is_self
    admin_self = (masks.left | masks.rejoined)[:, None] & is_self
    phase_bits = (
        masks.applied_ping.to(i32) * ev.PHASE_PING_RECV
        + masks.applied_resp.to(i32) * ev.PHASE_RESPONSE
        + masks.applied_pr.to(i32) * ev.PHASE_PING_REQ
        + (masks.ja_applied | join_learned).to(i32) * ev.PHASE_JOIN
        + masks.applied_faulty.to(i32) * ev.PHASE_EXPIRY
        + admin_self.to(i32) * ev.PHASE_ADMIN
    )
    changed = phase_bits > 0
    old_st = torch.where(prev_known, prev_status, -1).reshape(-1)
    inc = state.inc.reshape(-1)
    k = masks.pr_fs_mask.shape[1]
    self_inc = state.inc.narrow(1, lo, rows).diagonal()
    emissions = [
        # 1. pings: one event per initiated direct probe
        (masks.valid_send, ev.EV_PING, ids, target, -1, -1, 0, masks.delivered.to(i32)),
        # 2. view changes
        (changed, ev.EV_STATUS, row, col, old_st, state.status.reshape(-1), inc,
         phase_bits.reshape(-1)),
        # 3/4. detection verdicts (subsets of the status events)
        (masks.applied_sus, ev.EV_SUSPECT, row, col, old_st, SUSPECT, inc, 0),
        (masks.applied_faulty, ev.EV_FAULTY, row, col, old_st, FAULTY, inc, 0),
        # 5. full syncs: ping path (sender <- target), then ping-req path
        # (sender <- intermediary); aux = member records carried
        (masks.full_sync, ev.EV_FULL_SYNC, ids, target, -1, -1, 0, masks.fs_rec_rows),
        (masks.pr_fs_mask, ev.EV_FULL_SYNC, ids[:, None].expand(rows, k),
         masks.pr_sel.clamp(0, n - 1), -1, -1, 0, masks.pr_fs_recs),
    ] + [
        # 6. refutes: one event per phase a node re-asserted itself in
        (mask, ev.EV_REFUTE, ids, ids, -1, ALIVE, self_inc, phase_bit)
        for phase_bit, mask in (
            (ev.PHASE_PING_RECV, masks.refute_recv),
            (ev.PHASE_RESPONSE, masks.refute_resp),
            (ev.PHASE_PING_REQ, masks.refute_prm),
            (ev.PHASE_PING_REQ, masks.refute_prr),
        )
    ] + [
        # 7. joins: aux = members learned in the merge
        (masks.joined, ev.EV_JOIN, ids, -1, -1, -1, 0, join_learned.sum(dim=1, dtype=i32)),
    ]
    if sh.shards == 1:
        app = _Appender(state.ev_buf, state.ev_head, state.ev_drops)
        for e in emissions:
            app.append(e[0], tick, *e[1:])
    else:
        # each emission's total and this shard's offset in it
        counts = torch.stack([e[0].reshape(-1).to(i32).sum(dtype=i32) for e in emissions])
        every = (yield ("gather", counts)).reshape(sh.shards, EMISSIONS)
        offsets = (torch.cumsum(every, 0, dtype=i32) - every)[sh.index]
        totals = every.sum(dim=0, dtype=i32)
        block_lo, _ = capacity_block(capacity, sh.shards, sh.index)
        app = _Appender(state.ev_buf, state.ev_head, state.ev_drops, capacity, block_lo)
        for j, e in enumerate(emissions):
            app.append(e[0], tick, *e[1:], offset=offsets[j], total=totals[j])
        app.place((yield ("gather", app.collected())))

    # the first-heard wavefront matrix: every adoption this tick stamps
    # it; a revived process's row resets (its reborn self view is born now)
    first_heard = torch.where(
        masks.revived[:, None], torch.where(is_self, tick, -1), state.first_heard
    )
    first_heard = torch.where(changed, tick, first_heard).to(i32)
    buf, head, drops = app.result()
    return state._replace(ev_buf=buf, ev_head=head, ev_drops=drops, first_heard=first_heard)
