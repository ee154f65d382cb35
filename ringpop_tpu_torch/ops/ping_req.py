"""The full engine's ping-req phase (phase 7) on the card: the
intermediaries picked by a row scan, and only the slots whose
intermediary answered combined.

Four pieces, each a wrapper that launches its ``csrc/ping_req_*.cu`` on CUDA
tensors and runs its plain version on CPU tensors:

- :func:`ping_req_select`: each row's K intermediaries, the K smallest
  salt-29 uniforms over the pingable columns but the target, lower column
  first among ties (``argsort(stable)[:, :K]``; a row that needs no
  ping-req, or has no such column, gets columns 0..K-1, none valid);
- :func:`ping_req_combine`: leg 2, each answering slot's changes folded
  onto its intermediary's row (the largest key, the lowest slot among
  ties), as the apply site's update planes, and each row's arrivals;
- :func:`ping_req_hits`: leg 3's origin-filter counts;
- :func:`ping_req_respond`: leg 3, each sender's K responses (the
  intermediary's changes, or a full sync when it has none and the
  checksums differ) combined in slot order, with the full syncs and their
  record counts.

The plain versions are the engine's plain phase run for one shard holding
every row: :func:`ping_req_select_plain` and the legs
:func:`combine_legs`, :func:`hits_legs` and :func:`respond_legs`, which
``models/sim/engine.py`` runs on the CPU and, with collectives between
its shards, on a mesh.  Inside ``torch.func.vmap`` each wrapper goes
through a custom op whose batching rule launches the kernel once for all
B clusters.  uint32 values are int32 bit patterns (:mod:`.u32`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ringpop_tpu_torch.obs import perf
from ringpop_tpu_torch.ops import _build, toolkit, u32

SELECT_SALT = 29
INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# plain versions


def select_scores(base: torch.Tensor, n: int) -> torch.Tensor:
    """The engine's counter uniform at salt 29 (``engine._uniform``) of
    columns 0..n-1 for rows whose key word is ``base`` ([..., R] int32):
    [..., R, n] float32 in [0, 1]."""
    j = torch.arange(n, dtype=torch.int32, device=base.device)
    x = base[..., None] + j * u32.s32(0x01000193) + u32.s32(SELECT_SALT)
    x = x ^ u32.srl(x, 15)
    x = x * u32.s32(0x2C1B3C6D)
    x = x ^ u32.srl(x, 12)
    x = x * u32.s32(0x297A2D39)
    x = x ^ u32.srl(x, 15)
    return u32.to_f32(x) / float(2**32)


def ping_req_select_plain(pingable, target, need_pr, rng, k: int):
    """Plain version of :func:`ping_req_select`: the scored plane and a
    stable sort of each row.  Rows are independent: any leading axes."""
    n = pingable.shape[-1]
    ids = torch.arange(n, dtype=torch.int32, device=pingable.device)
    ok = pingable & (ids != target[..., None]) & need_pr[..., None]
    score = torch.where(ok, select_scores(rng[..., 0], n), 2.0)
    sel = torch.argsort(score, dim=-1, stable=True)[..., :k]
    return sel, torch.gather(score, -1, sel) < 1.5


def _pack_key(inc, status):
    """The winner-combine key (``engine._pack_key``): lexicographic
    (incarnation stamp, status rank)."""
    return inc * 4 + status


def _update(key, source, source_inc):
    """An apply site's update planes from a winner-combined key."""
    return (key >= 0, key % 4, torch.div(key, 4, rounding_mode="floor"), source, source_inc)


def _fetch(idx, *planes):
    """Rows ``idx`` (global node ids) of node-leading planes, from the
    shards that hold them."""
    return (yield ("fetch", (idx, planes)))


def _alone(body):
    """A leg's generator run for one shard holding every row: a fetch is
    the rows themselves, every other collective the identity."""
    reply = None
    while True:
        try:
            op, x = body.send(reply)
        except StopIteration as stop:
            return stop.value
        reply = [plane[x[0]] for plane in x[1]] if op == "fetch" else x


# The legs below are the phase's plain ops on a shard's rows [lo, lo + R)
# of a cluster's [N, N] planes: shard body generators in the protocol of
# ``engine.shard_tick``, which yields each read of another shard's rows as
# a collective (``rs_max``/``rs_min``/``rs_sum`` onto the intermediaries'
# rows, ``gather``, ``fetch``).  The engine runs them on a mesh and on the
# CPU; the kernels' plain versions run them alone.


def combine_legs(pr_sel, responder, active, pb, max_pb, ch_inc, ch_status, ch_source,
                 ch_source_inc, lo: int = 0):
    """Leg 2: each answering slot's arrivals folded onto its
    intermediary's row by segment reductions, [R*K, N] slot planes (slot
    (i, k) is global slot i*K + k; a slot that did not answer goes to the
    dropped segment n).  Returns the apply site's five update planes."""
    rows, n = active.shape
    k = pr_sel.shape[1]
    i32, dev = torch.int32, active.device
    slots = rows * k
    karange = torch.arange(k, dtype=i32, device=dev)
    arrive = (
        active[:, None, :]
        & (pb[:, None, :] + karange[None, :, None] + 1 <= max_pb[:, None, None])
        & responder[:, :, None]
    )
    seg = torch.where(responder, pr_sel.to(i32), n).reshape(slots)
    clip = seg.clamp(0, n - 1).to(torch.int64)
    keys = torch.where(arrive, _pack_key(ch_inc, ch_status)[:, None, :], -1).reshape(slots, n)
    recv_key = yield ("rs_max", toolkit.segment_reduce(keys, seg, n, "amax", INT32_MIN))
    (recv_at_m,) = yield from _fetch(clip, recv_key)
    is_w = (keys == recv_at_m) & (keys >= 0)
    ids = torch.arange(lo * k, lo * k + slots, dtype=i32, device=dev)[:, None].expand(slots, n)
    winner = yield ("rs_min", toolkit.segment_reduce(
        torch.where(is_w, ids, n * k), seg, n, "amin", INT32_MAX))
    (winner_at_m,) = yield from _fetch(clip, winner)
    final = is_w & (ids == winner_at_m)
    src3 = ch_source[:, None, :].expand(rows, k, n).reshape(slots, n)
    srcinc3 = ch_source_inc[:, None, :].expand(rows, k, n).reshape(slots, n)
    u_source = yield ("rs_max", toolkit.segment_reduce(
        torch.where(final, src3, INT32_MIN), seg, n, "amax", INT32_MIN))
    u_source_inc = yield ("rs_max", toolkit.segment_reduce(
        torch.where(final, srcinc3, INT32_MIN), seg, n, "amax", INT32_MIN))
    return _update(recv_key, u_source, u_source_inc)


def _arrival_plane(pr_sel, responder, n: int, lo: int):
    """[intermediary, sender] answering slots, the senders' columns [lo,
    lo + R) of a [N, N] plane."""
    cnt = torch.zeros((n, n), dtype=torch.int32, device=pr_sel.device)
    cols = torch.arange(lo, lo + pr_sel.shape[0], dtype=torch.int64, device=pr_sel.device)
    for s in range(pr_sel.shape[1]):
        cnt = cnt.index_put((pr_sel[:, s], cols), responder[:, s].to(torch.int32),
                            accumulate=True)
    return cnt


def hits_legs(pr_sel, responder, active, ch_source, ch_source_inc, self_inc, lo: int = 0):
    """Leg 3's origin filter: the arrival plane reduce-scattered to the
    intermediaries, read at each active cell's source (at the source's own
    incarnation ``self_inc``, gathered).  Returns the hits [R, N] and each
    intermediary's arrivals [R]."""
    n = active.shape[1]
    cnt = yield ("rs_sum", _arrival_plane(pr_sel, responder, n, lo))
    arrivals = cnt.sum(dim=1, dtype=torch.int32)
    self_inc_all = yield ("gather", self_inc)
    src_c = ch_source.clamp(0, n - 1).to(torch.int64)
    origin = active & (ch_source >= 0) & (ch_source_inc == self_inc_all[src_c])
    return torch.where(origin, torch.gather(cnt, 1, src_c), 0), arrivals


def respond_legs(pr_sel, responder, respondable, ch_source, ch_source_inc, known, status, inc,
                 ch_status, ch_inc, pr_self_inc, mid, mid_all, lo: int = 0):
    """Leg 3: each sender's K responses, its intermediaries' rows fetched
    whole slot by slot (the intermediary's changes, or a full sync of its
    known members when it has none and the checksums ``mid`` / ``mid_all``
    differ), combined in slot order: the strictly greatest key.  Returns
    the apply site's five update planes, the full syncs [R, K] and their
    record counts [R, K]."""
    rows, n = known.shape
    i32, dev = torch.int32, known.device
    node = torch.arange(lo, lo + rows, dtype=i32, device=dev)[:, None]
    best_key = torch.full((rows, n), -1, dtype=i32, device=dev)
    best_src = torch.full((rows, n), -1, dtype=i32, device=dev)
    best_srcinc = torch.zeros((rows, n), dtype=i32, device=dev)
    self_inc_all = yield ("gather", inc.narrow(1, lo, rows).diagonal())
    fs_list, rec_list = [], []
    for s in range(pr_sel.shape[1]):
        mk = pr_sel[:, s]
        (m_respondable, m_source, m_source_inc, m_known, m_status, m_inc, m_ch_status,
         m_ch_inc) = yield from _fetch(mk, respondable, ch_source, ch_source_inc, known, status,
                                       inc, ch_status, ch_inc)
        tells = (
            responder[:, s, None]
            & m_respondable
            & ~((m_source == node) & (m_source_inc == pr_self_inc[:, None]))
        )
        fs = responder[:, s] & ~tells.any(dim=1) & (mid_all[mk] != mid)
        fs_mask = fs[:, None] & m_known
        fs_list.append(fs)
        rec_list.append(fs_mask.sum(dim=1, dtype=i32))
        st = torch.where(fs_mask, m_status, m_ch_status)
        key = torch.where(tells | fs_mask, _pack_key(torch.where(fs_mask, m_inc, m_ch_inc), st), -1)
        better = key > best_key
        best_key = torch.where(better, key, best_key)
        best_src = torch.where(better, torch.where(fs_mask, mk.to(i32)[:, None], m_source),
                               best_src)
        best_srcinc = torch.where(
            better, torch.where(fs_mask, self_inc_all[mk][:, None], m_source_inc), best_srcinc)
    return (*_update(best_key, best_src, best_srcinc), torch.stack(fs_list, dim=1),
            torch.stack(rec_list, dim=1))


def ping_req_combine_plain(pr_sel, responder, active, pb, max_pb, ch_inc, ch_status, ch_source,
                           ch_source_inc):
    """Plain version of :func:`ping_req_combine` for one cluster:
    :func:`combine_legs` alone, and the arrival plane's row sums."""
    update = _alone(combine_legs(pr_sel, responder, active, pb, max_pb, ch_inc, ch_status,
                                 ch_source, ch_source_inc))
    arrivals = _arrival_plane(pr_sel, responder, active.shape[1], 0).sum(dim=1, dtype=torch.int32)
    return (*update, arrivals)


def ping_req_hits_plain(pr_sel, responder, active, ch_source, ch_source_inc, self_inc):
    """Plain version of :func:`ping_req_hits` for one cluster:
    :func:`hits_legs` alone."""
    return _alone(hits_legs(pr_sel, responder, active, ch_source, ch_source_inc, self_inc))[0]


def ping_req_respond_plain(pr_sel, responder, respondable, ch_source, ch_source_inc, known,
                           status, inc, ch_status, ch_inc, pr_self_inc, mid):
    """Plain version of :func:`ping_req_respond` for one cluster:
    :func:`respond_legs` alone."""
    return _alone(respond_legs(pr_sel, responder, respondable, ch_source, ch_source_inc, known,
                               status, inc, ch_status, ch_inc, pr_self_inc, mid, mid))


# ---------------------------------------------------------------------------
# the wrappers


def _count_slots(pr_sel: torch.Tensor) -> None:
    """Add the slots handed to the kernels (every vmapped cluster's rows
    times K) to the span log's ``ping_req_slots``: read from shapes, no
    device read."""
    if perf.active() is not None:
        perf.count("ping_req_slots", toolkit.unbatched(pr_sel).numel())


def ping_req_select(pingable, target, need_pr, rng, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's K intermediaries: ``(pr_sel [R, K] int64, pr_valid [R, K]
    bool)`` from ``pingable`` [R, N] bool, ``target`` [R] int32, ``need_pr``
    [R] bool and the rows' keys ``rng`` [R, 2] int32.  CUDA tensors launch
    the select kernel (one warp a row); CPU tensors run
    :func:`ping_req_select_plain`.  Counts ``ping_req_slots``."""
    if toolkit.is_batched(pingable, target, need_pr, rng):
        sel, valid = _select_op(pingable, target, need_pr, rng, k)
    else:
        sel, valid = _select_clusters(pingable, target, need_pr, rng, k)
    _count_slots(sel)
    return sel, valid


def ping_req_combine(pr_sel, responder, active, pb, max_pb, ch_inc, ch_status, ch_source,
                     ch_source_inc):
    """Leg 2 for one shard holding every row: each answering slot's
    arrivals (active cells within the budget after its bump) folded onto
    its intermediary's row.  Returns the apply site's ``(recv_mask,
    u_status, u_inc, u_source, u_source_inc)`` [R, N] planes and the
    arrivals a row [R] int32."""
    ops = (pr_sel, responder, active, pb, max_pb, ch_inc, ch_status, ch_source, ch_source_inc)
    if toolkit.is_batched(*ops):
        return tuple(_combine_op(*ops))
    return tuple(o[0] for o in _combine_clusters(*(t[None] for t in ops)))


def ping_req_hits(pr_sel, responder, active, ch_source, ch_source_inc, self_inc):
    """Leg 3's origin filter: per cell of an intermediary's row, the
    answering slots of the cell's source (active, at the source's own
    incarnation ``self_inc``) that reached that intermediary.  [R, N]
    int32."""
    ops = (pr_sel, responder, active, ch_source, ch_source_inc, self_inc)
    if toolkit.is_batched(*ops):
        return _hits_op(*ops)
    return _hits_clusters(*(t[None] for t in ops))[0]


def ping_req_respond(pr_sel, responder, respondable, ch_source, ch_source_inc, known, status,
                     inc, ch_status, ch_inc, pr_self_inc, mid):
    """Leg 3: each sender's responses combined in slot order.  Returns the
    apply site's five update planes, the full syncs [R, K] bool and their
    record counts [R, K] int32."""
    ops = (pr_sel, responder, respondable, ch_source, ch_source_inc, known, status, inc,
           ch_status, ch_inc, pr_self_inc, mid)
    if toolkit.is_batched(*ops):
        return tuple(_respond_op(*ops))
    return tuple(o[0] for o in _respond_clusters(*(t[None] for t in ops)))


ping_req_select.launches = 0
ping_req_combine.launches = 0
ping_req_hits.launches = 0
ping_req_respond.launches = 0


# ---------------------------------------------------------------------------
# B clusters: a loop of plain calls on the CPU, one launch on the card


def _per_cluster(plain, ops) -> list:
    outs = [plain(*(t[b] for t in ops)) for b in range(ops[0].shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return [torch.stack(list(xs)) for xs in zip(*outs)]


def _shape(name, dev, b, n, k, operands) -> None:
    """Check the ``[B, R(, N or K)]`` operands of one shard holding every
    row (R == N) before their pointers cross into C."""
    if not 1 <= k <= n:
        raise ValueError("%s: K = %d outside [1, N = %d]" % (name, k, n))
    dims = {"N": (b, n, n), "K": (b, n, k), "R": (b, n)}
    _build.check(name, dev, [(f, t, dt, dims[d]) for f, t, dt, d in operands])


def _select_clusters(pingable, target, need_pr, rng, k: int):
    """Rows of any leading shape: the plain version on the CPU, one launch
    of the select kernel over every row on the card."""
    if pingable.device.type == "cpu":
        return ping_req_select_plain(pingable, target, need_pr, rng, k)
    dev = pingable.device
    n = pingable.shape[-1]
    lead = tuple(pingable.shape[:-1])
    if not 1 <= k <= n:
        raise ValueError("ping_req_select: K = %d outside [1, N = %d]" % (k, n))
    c = (lambda t: t.contiguous())
    pingable, target, need_pr, rng = c(pingable), c(target), c(need_pr), c(rng)
    _build.check("ping_req_select", dev, (
        ("pingable", pingable, torch.bool, lead + (n,)), ("target", target, torch.int32, lead),
        ("need_pr", need_pr, torch.bool, lead), ("rng", rng, torch.int32, lead + (2,))))
    sel = torch.empty(lead + (k,), dtype=torch.int64, device=dev)
    valid = torch.empty(lead + (k,), dtype=torch.bool, device=dev)
    rows = target.numel()
    if rows:
        _build.library().call("ringpop_ping_req_select", dev,
                              [_build.ptr(t) for t in (pingable, target, need_pr, rng, sel, valid)],
                              rows, n, k)
        ping_req_select.launches += 1
    return sel, valid


def _combine_clusters(pr_sel, responder, active, pb, max_pb, ch_inc, ch_status, ch_source,
                      ch_source_inc):
    ops = (pr_sel, responder, active, pb, max_pb, ch_inc, ch_status, ch_source, ch_source_inc)
    if active.device.type == "cpu":
        return _per_cluster(ping_req_combine_plain, ops)
    dev = active.device
    b, _, n = active.shape
    k = pr_sel.shape[-1]
    ops = [t.contiguous() for t in ops]
    i32 = torch.int32
    _shape("ping_req_combine", dev, b, n, k, zip(
        ("pr_sel", "responder", "active", "pb", "max_pb", "ch_inc", "ch_status", "ch_source",
         "ch_source_inc"), ops,
        (torch.int64, torch.bool, torch.bool, i32, i32, i32, i32, i32, i32),
        "KKNNRNNNN"))
    mask = torch.empty((b, n, n), dtype=torch.bool, device=dev)
    planes = [torch.empty((b, n, n), dtype=i32, device=dev) for _ in range(4)]
    arrivals = torch.empty((b, n), dtype=i32, device=dev)
    # the combine words: only the rows an answering slot reaches are
    # cleared and read
    words = torch.empty((b, n, n), dtype=torch.int64, device=dev)
    _build.library().call("ringpop_ping_req_combine", dev,
                          [_build.ptr(t) for t in (*ops, mask, *planes, arrivals, words)],
                          b, n, k)
    ping_req_combine.launches += 1
    return [mask, *planes, arrivals]


def _hits_clusters(pr_sel, responder, active, ch_source, ch_source_inc, self_inc):
    ops = (pr_sel, responder, active, ch_source, ch_source_inc, self_inc)
    if active.device.type == "cpu":
        return _per_cluster(ping_req_hits_plain, ops)
    dev = active.device
    b, _, n = active.shape
    k = pr_sel.shape[-1]
    ops = [t.contiguous() for t in ops]
    i32 = torch.int32
    _shape("ping_req_hits", dev, b, n, k, zip(
        ("pr_sel", "responder", "active", "ch_source", "ch_source_inc", "self_inc"), ops,
        (torch.int64, torch.bool, torch.bool, i32, i32, i32), "KKNNNR"))
    hits = torch.empty((b, n, n), dtype=i32, device=dev)
    _build.library().call("ringpop_ping_req_hits", dev,
                          [_build.ptr(t) for t in (*ops, hits)], b, n, k)
    ping_req_hits.launches += 1
    return hits


def _respond_clusters(pr_sel, responder, respondable, ch_source, ch_source_inc, known, status,
                      inc, ch_status, ch_inc, pr_self_inc, mid):
    ops = (pr_sel, responder, respondable, ch_source, ch_source_inc, known, status, inc,
           ch_status, ch_inc, pr_self_inc, mid)
    if known.device.type == "cpu":
        return _per_cluster(ping_req_respond_plain, ops)
    dev = known.device
    b, _, n = known.shape
    k = pr_sel.shape[-1]
    ops = [t.contiguous() for t in ops]
    i32, b8 = torch.int32, torch.bool
    _shape("ping_req_respond", dev, b, n, k, zip(
        ("pr_sel", "responder", "respondable", "ch_source", "ch_source_inc", "known", "status",
         "inc", "ch_status", "ch_inc", "pr_self_inc", "mid"), ops,
        (torch.int64, b8, b8, i32, i32, b8, i32, i32, i32, i32, i32, i32), "KKNNNNNNNNRR"))
    mask = torch.empty((b, n, n), dtype=b8, device=dev)
    planes = [torch.empty((b, n, n), dtype=i32, device=dev) for _ in range(4)]
    fs = torch.empty((b, n, k), dtype=b8, device=dev)
    fs_rec = torch.empty((b, n, k), dtype=i32, device=dev)
    _build.library().call("ringpop_ping_req_respond", dev,
                          [_build.ptr(t) for t in (*ops, mask, *planes, fs, fs_rec)], b, n, k)
    ping_req_respond.launches += 1
    return [mask, *planes, fs, fs_rec]


# ---------------------------------------------------------------------------
# the batch axis: B clusters in one launch (the wrappers call the ops only
# inside vmap, where the rules below run instead)


def _front(info, in_dims, ops):
    return [toolkit.batch_front(t, d, info.batch_size) for t, d in zip(ops, in_dims)]


@torch.library.custom_op(toolkit.LIB + "::ping_req_select", mutates_args=())
def _select_op(pingable: torch.Tensor, target: torch.Tensor, need_pr: torch.Tensor,
               rng: torch.Tensor, k: int) -> List[torch.Tensor]:
    return list(_select_clusters(pingable, target, need_pr, rng, k))


def _select_rule(info, in_dims, pingable, target, need_pr, rng, k):
    return list(_select_clusters(*_front(info, in_dims, (pingable, target, need_pr, rng)),
                                 k)), [0, 0]


@torch.library.custom_op(toolkit.LIB + "::ping_req_combine", mutates_args=())
def _combine_op(pr_sel: torch.Tensor, responder: torch.Tensor, active: torch.Tensor,
                pb: torch.Tensor, max_pb: torch.Tensor, ch_inc: torch.Tensor,
                ch_status: torch.Tensor, ch_source: torch.Tensor,
                ch_source_inc: torch.Tensor) -> List[torch.Tensor]:
    ops = (pr_sel, responder, active, pb, max_pb, ch_inc, ch_status, ch_source, ch_source_inc)
    return [o[0] for o in _combine_clusters(*(t[None] for t in ops))]


def _combine_rule(info, in_dims, *ops):
    return list(_combine_clusters(*_front(info, in_dims, ops))), [0] * 6


@torch.library.custom_op(toolkit.LIB + "::ping_req_hits", mutates_args=())
def _hits_op(pr_sel: torch.Tensor, responder: torch.Tensor, active: torch.Tensor,
             ch_source: torch.Tensor, ch_source_inc: torch.Tensor,
             self_inc: torch.Tensor) -> torch.Tensor:
    ops = (pr_sel, responder, active, ch_source, ch_source_inc, self_inc)
    return _hits_clusters(*(t[None] for t in ops))[0]


def _hits_rule(info, in_dims, *ops):
    return _hits_clusters(*_front(info, in_dims, ops)), 0


@torch.library.custom_op(toolkit.LIB + "::ping_req_respond", mutates_args=())
def _respond_op(pr_sel: torch.Tensor, responder: torch.Tensor, respondable: torch.Tensor,
                ch_source: torch.Tensor, ch_source_inc: torch.Tensor, known: torch.Tensor,
                status: torch.Tensor, inc: torch.Tensor, ch_status: torch.Tensor,
                ch_inc: torch.Tensor, pr_self_inc: torch.Tensor,
                mid: torch.Tensor) -> List[torch.Tensor]:
    ops = (pr_sel, responder, respondable, ch_source, ch_source_inc, known, status, inc,
           ch_status, ch_inc, pr_self_inc, mid)
    return [o[0] for o in _respond_clusters(*(t[None] for t in ops))]


def _respond_rule(info, in_dims, *ops):
    return list(_respond_clusters(*_front(info, in_dims, ops))), [0] * 7


torch.library.register_vmap(toolkit.LIB + "::ping_req_select", _select_rule)
torch.library.register_vmap(toolkit.LIB + "::ping_req_combine", _combine_rule)
torch.library.register_vmap(toolkit.LIB + "::ping_req_hits", _hits_rule)
torch.library.register_vmap(toolkit.LIB + "::ping_req_respond", _respond_rule)
