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


class _Appender:
    """The buffer of one tick: a ``cap + 1``-row scratch (row ``cap``
    takes the dropped lanes) that every append writes into."""

    def __init__(self, buf, head, drops):
        self.cap = buf.shape[0]
        self.ext = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))])
        self.head = head
        self.drops = drops

    def append(self, mask, tick, kind, observer, subject, old_status, new_status, inc, aux):
        """Masked append of up to M candidate events, in lane order."""
        mask = mask.reshape(-1)
        m = mask.shape[0]
        dev = mask.device
        mask_i = mask.to(torch.int32)
        total = mask_i.sum(dtype=torch.int32)
        rank = torch.cumsum(mask_i, 0, dtype=torch.int32) - 1
        pos = self.head + rank
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
        self.ext.index_put_((tgt.to(torch.int64),), rec)
        end = self.head + total
        self.drops = self.drops + (end - self.cap).clamp(min=0)
        self.head = end.clamp(max=self.cap)

    def result(self):
        return self.ext[: self.cap], self.head, self.drops


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


def record_tick_events(state, tick, prev_known, prev_status, masks: TickEventMasks):
    """Append this tick's events; returns the state with new ``ev_*`` and
    ``first_heard`` fields.  Emission order, as in the JAX op: pings,
    status changes, suspect and faulty verdicts, full syncs (ping path,
    then ping-req path), refutes (four phases), joins."""
    n = prev_known.shape[0]
    dev = prev_known.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    row = ids[:, None].expand(n, n).reshape(-1)
    col = ids[None, :].expand(n, n).reshape(-1)
    is_self = ids[:, None] == ids[None, :]
    i32 = torch.int32
    app = _Appender(state.ev_buf, state.ev_head, state.ev_drops)
    target = masks.target.clamp(0, n - 1)

    # 1. pings: one event per initiated direct probe
    app.append(masks.valid_send, tick, ev.EV_PING, ids, target, -1, -1, 0,
               masks.delivered.to(i32))

    # 2. view changes: the union of every apply mask, the phases in aux;
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
    app.append(changed, tick, ev.EV_STATUS, row, col, old_st, state.status.reshape(-1),
               inc, phase_bits.reshape(-1))

    # 3/4. detection verdicts (subsets of the status events)
    app.append(masks.applied_sus, tick, ev.EV_SUSPECT, row, col, old_st, SUSPECT, inc, 0)
    app.append(masks.applied_faulty, tick, ev.EV_FAULTY, row, col, old_st, FAULTY, inc, 0)

    # 5. full syncs: ping path (sender <- target), then ping-req path
    # (sender <- intermediary); aux = member records carried
    app.append(masks.full_sync, tick, ev.EV_FULL_SYNC, ids, target, -1, -1, 0,
               masks.fs_rec_rows)
    k = masks.pr_fs_mask.shape[1]
    app.append(masks.pr_fs_mask, tick, ev.EV_FULL_SYNC, ids[:, None].expand(n, k),
               masks.pr_sel.clamp(0, n - 1), -1, -1, 0, masks.pr_fs_recs)

    # 6. refutes: one event per phase a node re-asserted itself in
    self_inc = state.inc.diagonal()
    for phase_bit, mask in (
        (ev.PHASE_PING_RECV, masks.refute_recv),
        (ev.PHASE_RESPONSE, masks.refute_resp),
        (ev.PHASE_PING_REQ, masks.refute_prm),
        (ev.PHASE_PING_REQ, masks.refute_prr),
    ):
        app.append(mask, tick, ev.EV_REFUTE, ids, ids, -1, ALIVE, self_inc, phase_bit)

    # 7. joins: aux = members learned in the merge
    app.append(masks.joined, tick, ev.EV_JOIN, ids, -1, -1, -1, 0,
               join_learned.sum(dim=1, dtype=i32))

    # the first-heard wavefront matrix: every adoption this tick stamps
    # it; a revived process's row resets (its reborn self view is born now)
    first_heard = torch.where(
        masks.revived[:, None], torch.where(is_self, tick, -1), state.first_heard
    )
    first_heard = torch.where(changed, tick, first_heard).to(i32)
    buf, head, drops = app.result()
    return state._replace(ev_buf=buf, ev_head=head, ev_drops=drops, first_heard=first_heard)
