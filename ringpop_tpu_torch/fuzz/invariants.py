"""Machine-checked SWIM protocol invariants over fuzzed runs.

Counterpart of ``ringpop_tpu/fuzz/invariants.py``, whose module docstring
tables every invariant and the property it holds.  The checkers are host
numpy code over already-fetched arrays and are copied as they are; the
run-level checker's three device steps have torch twins: the batch is
fetched to the host once (``_to_host``), sliced per instance in numpy,
and the scalable checksums are recomputed from scratch under
``torch.func.vmap``.  A violation names its invariant (the shrinker
minimizes against those names, and the mutation gates assert them).

Full-fidelity engine (event-stream grain): incarnation-monotonic,
view-continuity, alive-after-faulty-refute, self-view-alive,
suspicion-lower-bound, suspicion-upper-bound, piggyback-ceiling,
refute-reachability, metrics-reconcile, event-overflow,
event-stream-valid.  Scalable engine (state and metrics grain):
scalable-checksum-exact, scalable-proc-alive, suspicion-lower-bound,
refutes-need-defamation, pings-conserved.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ringpop_tpu_torch.fuzz.scenarios import FULL, SCALABLE
from ringpop_tpu_torch.obs import events as ev

ALIVE, SUSPECT, FAULTY, LEAVE = 0, 1, 2, 3


class Violation(NamedTuple):
    invariant: str
    instance: int  # batch index within the run
    message: str


def _v(name: str, instance: int, msg: str) -> Violation:
    return Violation(name, instance, msg)


# -- schedule-derived traces -------------------------------------------------


def _liveness_trace(schedule, ticks: int, n: int):
    """(alive[T+1, N], reset[T, N], disturbed[T, N]) from the fault plane.

    ``alive[t]`` is process liveness entering schedule row t; ``reset``
    marks revive-of-dead rows (full state reset); ``disturbed`` marks any
    operator touch of the node at that row (kill/revive/resume/leave/
    join) — the suspicion upper bound is only exact for undisturbed
    observers."""
    alive = np.ones((ticks + 1, n), bool)
    reset = np.zeros((ticks, n), bool)
    disturbed = np.zeros((ticks, n), bool)
    kill = np.asarray(schedule.kill)
    revive = np.asarray(schedule.revive)
    resume = getattr(schedule, "resume", None)
    leave = getattr(schedule, "leave", None)
    join = getattr(schedule, "join", None)
    for t in range(ticks):
        cur = alive[t]
        reset[t] = revive[t] & ~cur
        nxt = (cur & ~kill[t]) | revive[t]
        if resume is not None:
            nxt = nxt | np.asarray(resume)[t]
        alive[t + 1] = nxt
        disturbed[t] = kill[t] | revive[t]
        if resume is not None:
            disturbed[t] |= np.asarray(resume)[t]
        if leave is not None:
            disturbed[t] |= np.asarray(leave)[t]
        if join is not None:
            disturbed[t] |= np.asarray(join)[t]
    return alive, reset, disturbed


def _group_trace(schedule, ticks: int, n: int) -> np.ndarray:
    """[T, N] partition-group assignment in effect at each schedule row
    (the engines apply the row's regroup before any exchange)."""
    out = np.zeros((ticks, n), np.int32)
    part = getattr(schedule, "partition", None)
    cur = np.zeros(n, np.int32)
    for t in range(ticks):
        if part is not None:
            row = np.asarray(part)[t]
            cur = np.where(row >= 0, row, cur).astype(np.int32)
        out[t] = cur
    return out


def _reachable(groups: np.ndarray, src: int, t0: int, dst: int, t1: int) -> bool:
    """Could information flow from ``src`` at schedule row t0 to ``dst``
    by row t1, hopping only between same-group nodes each row?

    Deliberately an OVER-approximation of the engines' channels (any
    same-group pair MAY exchange in a row; liveness is ignored): the
    checker must never flag a flow the engine could have made, only
    flows no partition-respecting path could carry."""
    n = groups.shape[1]
    frontier = np.zeros(n, bool)
    frontier[src] = True
    for t in range(max(t0, 0), min(t1 + 1, groups.shape[0])):
        g = groups[t]
        touched = np.unique(g[frontier])
        frontier = frontier | np.isin(g, touched)
        if frontier[dst]:
            return True
    return bool(frontier[dst])


# -- full-fidelity checker ---------------------------------------------------


def _event_arrays(events: Any) -> Dict[str, np.ndarray]:
    arrs = ev._as_arrays(events)
    return {k: np.asarray(v) for k, v in arrs.items()}


def check_full_instance(
    events: Any,
    final_state: Any,  # this instance's SimState slice (numpy pytree)
    metrics: Any,  # TickMetrics of [T] arrays for this instance
    schedule: Any,  # EventSchedule driving the instance
    params: Any,  # the params the run executed under
    instance: int = 0,
    contract: Optional[Any] = None,  # params the PROTOCOL demands
    drops: int = 0,
) -> List[Violation]:
    """All full-engine invariants for one scenario instance."""
    contract = contract if contract is not None else params
    out: List[Violation] = []
    n, ticks = schedule.n, schedule.ticks
    alive_tr, reset_tr, disturbed_tr = _liveness_trace(schedule, ticks, n)
    groups = _group_trace(schedule, ticks, n)

    if drops:
        out.append(
            _v(
                "event-overflow",
                instance,
                "flight recorder dropped %d events — the stream cannot "
                "witness the remaining invariants" % drops,
            )
        )
    if isinstance(events, (list, tuple)) and events and isinstance(
        events[0], dict
    ):
        problems = ev.validate_event_stream(events)
        for p in problems[:4]:
            out.append(_v("event-stream-valid", instance, p))

    a = _event_arrays(events)
    tick_a = a["tick"]
    kind = a["kind"]
    obs_a = a["observer"]
    subj = a["subject"]
    old_st = a["old_status"]
    new_st = a["new_status"]
    inc = a["inc"]

    # event tick T corresponds to schedule row T-1 (tick_index starts 0,
    # the first scanned row records tick 1)
    def row_of(t: int) -> int:
        return int(t) - 1

    # refute events by subject: (tick, inc) pairs, plus fault-plane
    # rebirth rows — the two legitimate sources of fresh ALIVE stamps.
    # A rebirth stamp is minted by the revive reset / rejoin write
    # itself (row r mints stamp r+2), NOT by a later successful join —
    # a revived node whose join finds no reachable candidate still
    # carries its fresh self-incarnation, and other nodes' join merges
    # may pick the unready process up (handleJoin never checks
    # readiness), so the stamp can disseminate without any EV_JOIN.
    ref_sel = kind == ev.EV_REFUTE
    refutes_by = {}
    for i in np.nonzero(ref_sel)[0]:
        refutes_by.setdefault(int(obs_a[i]), []).append(
            (int(tick_a[i]), int(inc[i]))
        )
    rebirth_rows = {}  # subject -> rows minting a fresh ALIVE stamp
    join_plane = np.asarray(schedule.join)
    for s in range(n):
        rows = set(np.nonzero(reset_tr[:, s])[0].tolist())
        rows |= set(np.nonzero(join_plane[:, s])[0].tolist())
        rebirth_rows[s] = rows

    # -- per-(observer, subject) view-change sequences -------------------
    st_sel = np.nonzero(kind == ev.EV_STATUS)[0]
    order = st_sel[
        np.lexsort(
            (st_sel, tick_a[st_sel], subj[st_sel], obs_a[st_sel])
        )
    ]
    prev_of: Dict[tuple, int] = {}
    for i in order:
        o, s, t = int(obs_a[i]), int(subj[i]), int(tick_a[i])
        if o == s and int(new_st[i]) in (SUSPECT, FAULTY):
            out.append(
                _v(
                    "self-view-alive",
                    instance,
                    "node %d holds itself %s at tick %d instead of "
                    "refuting"
                    % (o, "SUSPECT" if int(new_st[i]) == SUSPECT else "FAULTY", t),
                )
            )
        key = (o, s)
        j = prev_of.get(key)
        prev_of[key] = i
        fresh = int(old_st[i]) == -1
        if j is None or fresh:
            continue
        # observer reset (revive-of-dead) between the two events starts a
        # new lifetime even when the relearn reuses the stale row view
        # (a same-tick revive+rejoin reads the pre-crash view as old)
        t_prev = int(tick_a[j])
        seg = reset_tr[max(row_of(t_prev), 0): row_of(t) + 1, o].any()
        if seg:
            continue
        if int(inc[i]) < int(inc[j]):
            out.append(
                _v(
                    "incarnation-monotonic",
                    instance,
                    "observer %d's view of %d regressed inc %d -> %d at "
                    "tick %d (prev event tick %d)"
                    % (o, s, int(inc[j]), int(inc[i]), t, t_prev),
                )
            )
        if int(old_st[i]) != int(new_st[j]):
            out.append(
                _v(
                    "view-continuity",
                    instance,
                    "observer %d's view of %d jumped %d -> old %d at tick "
                    "%d without an event for the change"
                    % (o, s, int(new_st[j]), int(old_st[i]), t),
                )
            )
        # FAULTY -> ALIVE needs a refute at exactly the new incarnation,
        # or a fault-plane rebirth of the subject no later than the flip
        if int(new_st[j]) == FAULTY and int(new_st[i]) == ALIVE:
            a_inc = int(inc[i])
            ok = any(
                rt <= t and rinc == a_inc
                for rt, rinc in refutes_by.get(s, ())
            )
            if not ok:
                # rebirth row r mints stamp r+2 at event tick r+1
                ok = any(
                    r + 1 <= t and a_inc == r + 2
                    for r in rebirth_rows.get(s, ())
                )
            if not ok:
                out.append(
                    _v(
                        "alive-after-faulty-refute",
                        instance,
                        "observer %d flipped %d FAULTY -> ALIVE@inc %d at "
                        "tick %d with no refute/rebirth minting that "
                        "incarnation" % (o, s, a_inc, t),
                    )
                )

    # -- suspicion timeout bounds ---------------------------------------
    # arms: status events ending SUSPECT; fires: EV_FAULTY (expiry-applied)
    arm_ticks: Dict[tuple, List[int]] = {}
    for i in order:
        if int(new_st[i]) == SUSPECT:
            arm_ticks.setdefault(
                (int(obs_a[i]), int(subj[i])), []
            ).append(int(tick_a[i]))
    sus_ticks = int(contract.suspicion_ticks)
    for i in np.nonzero(kind == ev.EV_FAULTY)[0]:
        o, s, t = int(obs_a[i]), int(subj[i]), int(tick_a[i])
        arms = [ta for ta in arm_ticks.get((o, s), ()) if ta < t]
        if not arms:
            out.append(
                _v(
                    "suspicion-lower-bound",
                    instance,
                    "observer %d expired %d faulty at tick %d without any "
                    "prior suspect arming" % (o, s, t),
                )
            )
            continue
        t_arm = max(arms)
        if t - t_arm < sus_ticks:
            out.append(
                _v(
                    "suspicion-lower-bound",
                    instance,
                    "observer %d expired %d faulty %d ticks after arming "
                    "(tick %d -> %d), contract requires >= %d"
                    % (o, s, t - t_arm, t_arm, t, sus_ticks),
                )
            )
        else:
            win = disturbed_tr[
                max(row_of(t_arm) + 1, 0): row_of(t) + 1, o
            ]
            if not win.any() and t - t_arm != sus_ticks:
                out.append(
                    _v(
                        "suspicion-upper-bound",
                        instance,
                        "undisturbed observer %d expired %d at tick %d, "
                        "%d ticks after arming at %d (deadline is exactly "
                        "%d)" % (o, s, t, t - t_arm, t_arm, sus_ticks),
                    )
                )

    # -- piggyback ceiling (final-state snapshot) ------------------------
    ch_active = np.asarray(final_state.ch_active)
    ch_pb = np.asarray(final_state.ch_pb)
    digits = len(str(n))  # ceil(log10(n+1)) for n >= 1
    ceiling = int(contract.piggyback_factor) * digits
    over = ch_active & (ch_pb > ceiling)
    if over.any():
        o, s = np.argwhere(over)[0]
        out.append(
            _v(
                "piggyback-ceiling",
                instance,
                "active change (%d, %d) carries piggyback count %d > "
                "ceiling %d" % (int(o), int(s), int(ch_pb[o, s]), ceiling),
            )
        )

    # -- partition-reachability of refuted defamations -------------------
    # each refute needs SOME defamation of the subject whose accuser
    # could reach the subject through the groups in effect since
    defam: Dict[int, List[tuple]] = {}
    for i in order:
        if int(new_st[i]) in (SUSPECT, FAULTY) and int(obs_a[i]) != int(
            subj[i]
        ):
            defam.setdefault(int(subj[i]), []).append(
                (int(tick_a[i]), int(obs_a[i]))
            )
    for i in np.nonzero(ref_sel)[0]:
        s, t = int(obs_a[i]), int(tick_a[i])
        cands = [d for d in defam.get(s, ()) if d[0] <= t]
        if not cands:
            out.append(
                _v(
                    "refute-reachability",
                    instance,
                    "node %d refuted at tick %d with no prior defamation "
                    "event anywhere" % (s, t),
                )
            )
            continue
        if not any(
            _reachable(groups, o, row_of(t0), s, row_of(t))
            for t0, o in cands
        ):
            out.append(
                _v(
                    "refute-reachability",
                    instance,
                    "node %d refuted at tick %d but no defaming accuser "
                    "could reach it through the partition groups"
                    % (s, t),
                )
            )

    # -- metrics <-> event-stream reconciliation -------------------------
    rec = ev.reconcile(a, metrics)
    for field, row in rec.items():
        if not row["match"]:
            out.append(
                _v(
                    "metrics-reconcile",
                    instance,
                    "%s: events=%d metrics=%d"
                    % (field, row["events"], row["metrics"]),
                )
            )
    return out


# -- scalable checker --------------------------------------------------------


def check_scalable_instance(
    final_state: Any,  # numpy pytree slice of ScalableState
    metrics: Any,  # ScalableMetrics of [T] arrays
    schedule: Any,  # StormSchedule
    params: Any,
    instance: int = 0,
    contract: Optional[Any] = None,
    recomputed_checksum: Optional[np.ndarray] = None,
) -> List[Violation]:
    contract = contract if contract is not None else params
    out: List[Violation] = []
    n, ticks = schedule.n, schedule.ticks

    # incremental in-tick checksums == full O(N*U) recompute, bitwise
    if recomputed_checksum is not None and bool(params.checksum_in_tick):
        got = np.asarray(final_state.checksum)
        want = np.asarray(recomputed_checksum)
        if not np.array_equal(got, want):
            bad = int(np.nonzero(got != want)[0][0])
            out.append(
                _v(
                    "scalable-checksum-exact",
                    instance,
                    "incremental checksum diverged from full recompute at "
                    "node %d: 0x%08x != 0x%08x"
                    % (bad, int(got[bad]), int(want[bad])),
                )
            )

    # final process-liveness is the schedule folded exactly
    alive_tr, _, _ = _liveness_trace(schedule, ticks, n)
    got_alive = np.asarray(final_state.proc_alive)
    if not np.array_equal(got_alive, alive_tr[ticks]):
        bad = int(np.nonzero(got_alive != alive_tr[ticks])[0][0])
        out.append(
            _v(
                "scalable-proc-alive",
                instance,
                "node %d liveness %r but the fault schedule folds to %r"
                % (bad, bool(got_alive[bad]), bool(alive_tr[ticks][bad])),
            )
        )

    sus = np.asarray(metrics.suspects_published)
    fau = np.asarray(metrics.faulties_published)
    ref = np.asarray(metrics.refutes_published)
    sus_ticks = int(contract.suspicion_ticks)
    for t in np.nonzero(fau > 0)[0]:
        # row t runs engine tick t+1; a faulty batch needs a suspect
        # batch whose clock had >= suspicion_ticks to run
        if t < sus_ticks or not (sus[: t - sus_ticks + 1] > 0).any():
            out.append(
                _v(
                    "suspicion-lower-bound",
                    instance,
                    "faulty batch at row %d without a suspect batch >= %d "
                    "ticks earlier" % (int(t), sus_ticks),
                )
            )
    # refutes answer defamations: revive/rejoin rows publish in the same
    # alive batch but are counted separately (refutes_published counts
    # only the refuter mask)
    for t in np.nonzero(ref > 0)[0]:
        if not (sus[: t + 1] > 0).any() and not (fau[: t + 1] > 0).any():
            out.append(
                _v(
                    "refutes-need-defamation",
                    instance,
                    "refute batch at row %d before any suspect/faulty "
                    "batch" % int(t),
                )
            )
    sent = np.asarray(metrics.pings_sent)
    deliv = np.asarray(metrics.pings_delivered)
    if (deliv > sent).any():
        t = int(np.nonzero(deliv > sent)[0][0])
        out.append(
            _v(
                "pings-conserved",
                instance,
                "row %d delivered %d pings of %d sent"
                % (t, int(deliv[t]), int(sent[t])),
            )
        )
    return out


# -- the run-level checker ---------------------------------------------------


def _to_host(tree: Any) -> Any:
    """A state or metrics tuple with every field as host numpy (uint32
    fields of an engine state as uint32): the whole batch fetched once, so
    the per-instance slices below are numpy views, not B device-to-host
    transfers of the full [B, ...] state."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    if isinstance(tree, engine.SimState):
        return engine.SimState(**convert.state_to_numpy(tree))
    if isinstance(tree, es.ScalableState):
        return es.ScalableState(**convert.scalable_state_to_numpy(tree))
    return type(tree)(*(None if x is None else np.asarray(
        x.to("cpu").numpy() if isinstance(x, torch.Tensor) else x) for x in tree))


def _instance_slice(tree: Any, b: int) -> Any:
    """Instance ``b`` of every [B, ...] field (host numpy)."""
    return type(tree)(*(None if x is None else np.asarray(x)[b] for x in tree))


def _instance_prefix(tree: Any, k: int) -> Any:
    """The first ``k`` instances of every [B, ...] field."""
    return type(tree)(*(None if x is None else x[:k] for x in tree))


def _recomputed_checksums(run: Any) -> np.ndarray:
    """[B, N] uint32: every instance's scalable checksums recomputed from
    scratch (``compute_checksums`` under ``torch.func.vmap``)."""
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.ops import u32

    st = run.final_state
    present = tuple(f for f in st._fields if getattr(st, f) is not None)
    absent = {f: None for f in st._fields if getattr(st, f) is None}

    def one(tensors):
        return es.compute_checksums(
            es.ScalableState(**absent, **dict(zip(present, tensors))), run.params
        )

    return u32.to_numpy(torch.func.vmap(one)(tuple(getattr(st, f) for f in present)))


def check_run(
    run: Any,  # executor.FuzzRun
    contract: Optional[Any] = None,
) -> Dict[int, List[Violation]]:
    """Check every instance of a batched run; returns {batch index:
    violations} for instances with at least one violation."""
    out: Dict[int, List[Violation]] = {}
    b_count = len(run.schedules)
    recomputed = None
    if run.engine == SCALABLE and bool(run.params.checksum_in_tick):
        recomputed = _recomputed_checksums(run)
    final_host = _to_host(run.final_state)
    metrics_host = _to_host(run.metrics)
    for b in range(b_count):
        fs = _instance_slice(final_host, b)
        ms = _instance_slice(metrics_host, b)
        if run.engine == FULL:
            vs = check_full_instance(
                run.events[b],
                fs,
                ms,
                run.schedules[b],
                run.params,
                instance=b,
                contract=contract,
                drops=run.drops[b] if run.drops else 0,
            )
        else:
            vs = check_scalable_instance(
                fs,
                ms,
                run.schedules[b],
                run.params,
                instance=b,
                contract=contract,
                recomputed_checksum=(
                    recomputed[b] if recomputed is not None else None
                ),
            )
        if vs:
            out[b] = vs
    return out


def violation_names(
    violations: Sequence[Violation],
) -> List[str]:
    return sorted({v.invariant for v in violations})
