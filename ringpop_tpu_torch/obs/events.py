"""Flight-recorder event registry + host-side decoding and derivations.

A copy of ``ringpop_tpu/obs/events.py`` (numpy only): the port's flight
recorder (``models/sim/flight.py``) writes the same record layout, so the
same decoders read either package's buffers.

The device-side protocol flight recorder (models/sim/flight.py) appends
fixed-width int32 records into a linear on-device buffer carried through
the scanned tick — written with masked scatters under the *same masks
that drive the trajectory*, so enabling it is trajectory-neutral and
callback-free.  This
module is the HOST half: the kind registry, the decoder, reconciliation
against ``TickMetrics`` counters, and the rumor-wavefront derivations
(dissemination latency, infection hop counts, per-rumor convergence
curves) that turn the SWIM O(log n) epidemic-broadcast claim into a
measured artifact.

Record layout (one row = one event, ``RECORD_WIDTH`` int32 slots)::

    [tick, kind, observer, subject, old_status, new_status, inc, aux]

- ``tick``       — 1-based engine tick index (SimState.tick_index after
  the tick ran).
- ``kind``       — code from :data:`EVENT_KINDS`.
- ``observer``   — the node whose view/action the event describes.
- ``subject``    — the other node involved (-1 when not applicable).
- ``old_status`` — observer's view of subject at the START of the tick
  (-1 = unknown member; only meaningful for view-change kinds).
- ``new_status`` — observer's view at the END of the tick (-1 n/a).
- ``inc``        — the engine's int32 incarnation STAMP attached to the
  event (0 when not applicable); ``engine.stamp_to_ms`` converts.
- ``aux``        — kind-specific (see the table below).

Event kinds and their aux semantics:

=============  ====  =======================================================
name           code  meaning (observer / subject / aux)
=============  ====  =======================================================
ping              0  direct ping sent: sender / target / aux=1 if delivered
status            1  view change applied: observer / subject / aux=phase
                     bitmask (1 ping-recv, 2 response, 4 ping-req, 8 join,
                     16 suspicion-expiry, 32 admin leave/rejoin self-write)
suspect           2  ping-req verdict marked subject suspect:
                     observer / subject / aux=0
faulty            3  suspicion expiry marked subject faulty:
                     observer / subject / aux=0
full_sync         4  full membership sync received: the pinging sender /
                     the responding node / aux=member records carried
refute            5  node saw itself defamed and re-asserted alive:
                     observer == subject / aux=phase bitmask (as above)
join              6  joiner merged target views and became ready:
                     joiner / -1 / aux=members learned
=============  ====  =======================================================

Rumor identity: a rumor is born when a member first asserts (or is
asserted at) a new ``(subject, status, incarnation)`` triple; every
``status`` event carrying that triple is one node's first adoption of the
rumor, so the event stream IS the wavefront (``rumor_wavefronts``).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

RECORD_WIDTH = 8
FIELDS = (
    "tick",
    "kind",
    "observer",
    "subject",
    "old_status",
    "new_status",
    "inc",
    "aux",
)
# field slot indices (device and host must agree)
(
    F_TICK,
    F_KIND,
    F_OBSERVER,
    F_SUBJECT,
    F_OLD_STATUS,
    F_NEW_STATUS,
    F_INC,
    F_AUX,
) = range(RECORD_WIDTH)

EV_PING = 0
EV_STATUS = 1
EV_SUSPECT = 2
EV_FAULTY = 3
EV_FULL_SYNC = 4
EV_REFUTE = 5
EV_JOIN = 6

EVENT_KINDS: Dict[int, str] = {
    EV_PING: "ping",
    EV_STATUS: "status",
    EV_SUSPECT: "suspect",
    EV_FAULTY: "faulty",
    EV_FULL_SYNC: "full_sync",
    EV_REFUTE: "refute",
    EV_JOIN: "join",
}
KIND_CODES: Dict[str, int] = {v: k for k, v in EVENT_KINDS.items()}

# status-event aux bitmask: which tick phase(s) applied the change
PHASE_PING_RECV = 1
PHASE_RESPONSE = 2
PHASE_PING_REQ = 4
PHASE_JOIN = 8
PHASE_EXPIRY = 16
# operator-plane self-transitions: graceful leave / rejoin write the
# origin's OWN view outside the gossip apply masks — without this bit
# the rumor's birth would be misattributed to its first OTHER hearer
PHASE_ADMIN = 32


def decode_arrays(buf: Any, head: Any) -> Dict[str, np.ndarray]:
    """Device buffer -> {field: np.ndarray} over the ``head`` valid rows.

    The cheap columnar form — reconciliation and wavefront math stay in
    numpy instead of per-event dicts."""
    buf = np.asarray(buf)
    if buf.ndim != 2 or buf.shape[1] != RECORD_WIDTH:
        raise ValueError(
            "event buffer must be [cap, %d] int32, got %r"
            % (RECORD_WIDTH, buf.shape)
        )
    head = int(np.asarray(head))
    head = max(0, min(head, buf.shape[0]))
    rows = buf[:head]
    return {name: rows[:, i].copy() for i, name in enumerate(FIELDS)}


def decode_events(buf: Any, head: Any, drops: Any = 0) -> List[Dict[str, int]]:
    """Device buffer -> list of per-event dicts (with ``kind_name``).

    ``drops`` (SimState.ev_drops) is not part of the rows; it is threaded
    through so callers see overflow honesty in one place — a nonzero
    value means the buffer filled and the TAIL of the stream is missing
    (the recorder drops new events rather than overwriting old ones)."""
    arrs = decode_arrays(buf, head)
    out: List[Dict[str, int]] = []
    for i in range(len(arrs["tick"])):
        ev = {name: int(arrs[name][i]) for name in FIELDS}
        ev["kind_name"] = EVENT_KINDS.get(ev["kind"], "unknown-%d" % ev["kind"])
        out.append(ev)
    if int(np.asarray(drops)):
        # annotate rather than raise: a truncated stream is still usable
        # for every derivation over its prefix
        for ev in out:
            ev.setdefault("truncated_stream", True)
    return out


def _as_arrays(events: Any) -> Dict[str, np.ndarray]:
    """Accept decode_arrays output, decode_events output, or a raw
    (buf, head) pair."""
    if isinstance(events, dict):
        missing = [f for f in FIELDS if f not in events]
        if missing:
            # a field-incomplete dict would otherwise surface as a bare
            # KeyError deep inside a derivation lambda
            raise ValueError(
                "columnar events dict is missing fields %r" % (missing,)
            )
        return events
    if isinstance(events, (list, tuple)) and events and isinstance(
        events[0], dict
    ):
        for i, e in enumerate(events):
            missing = [f for f in FIELDS if f not in e]
            if missing:
                raise ValueError(
                    "event %d is missing fields %r" % (i, missing)
                )
        return {
            name: np.asarray([ev[name] for ev in events], np.int64)
            for name in FIELDS
        }
    if isinstance(events, (list, tuple)) and len(events) in (2, 3):
        return decode_arrays(events[0], events[1])
    if not events:
        return {name: np.zeros(0, np.int64) for name in FIELDS}
    raise TypeError("unsupported events representation: %r" % type(events))


# -- reconciliation against TickMetrics -------------------------------------

# TickMetrics field -> (how to compute the same total from the stream)
_RECONCILE: Dict[str, Any] = {
    "pings_sent": lambda a: int(np.sum(a["kind"] == EV_PING)),
    "pings_delivered": lambda a: int(
        np.sum(a["aux"][a["kind"] == EV_PING])
    ),
    "suspects_marked": lambda a: int(np.sum(a["kind"] == EV_SUSPECT)),
    "faulties_marked": lambda a: int(np.sum(a["kind"] == EV_FAULTY)),
    "full_syncs": lambda a: int(np.sum(a["kind"] == EV_FULL_SYNC)),
    "full_sync_records": lambda a: int(
        np.sum(a["aux"][a["kind"] == EV_FULL_SYNC])
    ),
    "refutes": lambda a: int(np.sum(a["kind"] == EV_REFUTE)),
    "join_merges": lambda a: int(np.sum(a["kind"] == EV_JOIN)),
}


def reconcile(events: Any, metrics: Any) -> Dict[str, Dict[str, int]]:
    """Decoded event stream vs ``TickMetrics`` window totals.

    Returns {field: {"events": n, "metrics": n, "match": bool}} for every
    counter with a defined event-stream equivalent — the honesty gate the
    acceptance criteria pin (tests/models/test_flight_recorder.py)."""
    arrs = _as_arrays(events)
    if hasattr(metrics, "_asdict"):
        metrics = metrics._asdict()
    out: Dict[str, Dict[str, int]] = {}
    for field, derive in _RECONCILE.items():
        if field not in metrics:
            continue
        m_total = int(np.asarray(metrics[field]).sum())
        e_total = derive(arrs)
        out[field] = {
            "events": e_total,
            "metrics": m_total,
            "match": e_total == m_total,
        }
    return out


# -- rumor wavefront derivations --------------------------------------------


def rumor_wavefronts(events: Any) -> Dict[tuple, Dict[str, Any]]:
    """Group ``status`` events into rumor wavefronts.

    A rumor is a ``(subject, new_status, inc)`` triple; a node's FIRST
    ``status`` event carrying the triple is its first-heard tick.
    Returns ``{rumor: {"birth": tick, "first_heard": {observer: tick},
    "convergence_curve": [(tick, cumulative observers)], ...}}``."""
    arrs = _as_arrays(events)
    sel = arrs["kind"] == EV_STATUS
    ticks = arrs["tick"][sel]
    obs = arrs["observer"][sel]
    subj = arrs["subject"][sel]
    status = arrs["new_status"][sel]
    inc = arrs["inc"][sel]

    first: Dict[tuple, Dict[int, int]] = {}
    order = np.argsort(ticks, kind="stable")
    for i in order:
        rid = (int(subj[i]), int(status[i]), int(inc[i]))
        fh = first.setdefault(rid, {})
        o = int(obs[i])
        if o not in fh:
            fh[o] = int(ticks[i])
    out: Dict[tuple, Dict[str, Any]] = {}
    for rid, fh in first.items():
        birth = min(fh.values())
        # one pass over counts-by-tick, not a rescan of fh per distinct
        # tick — the curve build is O(observers) per rumor
        by_tick = Counter(fh.values())
        waves = sorted(by_tick)
        curve: List[tuple] = []
        seen = 0
        for t in waves:
            seen += by_tick[t]
            curve.append((t, seen))
        wave_rank = {t: k for k, t in enumerate(waves)}
        out[rid] = {
            "subject": rid[0],
            "status": rid[1],
            "inc": rid[2],
            "birth": birth,
            "first_heard": fh,
            "convergence_curve": curve,
            "convergence_tick": max(fh.values()),
            # dissemination latency per observer, in ticks since birth
            "latency": {o: t - birth for o, t in fh.items()},
            # infection hop count: which epidemic generation (distinct
            # adoption wave) the observer joined in — generation 0 is
            # the rumor's origin tick
            "hops": {o: wave_rank[t] for o, t in fh.items()},
        }
    return out


def dissemination_summary(
    wavefronts: Dict[tuple, Dict[str, Any]],
    min_observers: int = 2,
) -> Dict[str, Any]:
    """Aggregate dissemination-latency statistics across rumors.

    ``min_observers`` filters single-observer rumors (a change that never
    disseminated has no latency distribution).  Returns a JSON-ready dict
    with a latency histogram (ticks-to-hear counts), per-rumor
    convergence ticks, and hop-count distribution."""
    lat_hist: Dict[int, int] = {}
    hop_hist: Dict[int, int] = {}
    per_rumor: List[Dict[str, Any]] = []
    for rid, wf in sorted(wavefronts.items()):
        if len(wf["first_heard"]) < min_observers:
            continue
        for v in wf["latency"].values():
            lat_hist[v] = lat_hist.get(v, 0) + 1
        for v in wf["hops"].values():
            hop_hist[v] = hop_hist.get(v, 0) + 1
        per_rumor.append(
            {
                "subject": wf["subject"],
                "status": wf["status"],
                "inc": wf["inc"],
                "birth": wf["birth"],
                "observers": len(wf["first_heard"]),
                "convergence_tick": wf["convergence_tick"],
                "convergence_latency": wf["convergence_tick"] - wf["birth"],
                "convergence_curve": [list(p) for p in wf["convergence_curve"]],
            }
        )
    return {
        "rumors": per_rumor,
        "latency_histogram_ticks": {
            str(k): v for k, v in sorted(lat_hist.items())
        },
        "hop_histogram": {str(k): v for k, v in sorted(hop_hist.items())},
    }


def scalable_wavefront_summary(
    first_heard: Any,  # [N, U] int32, -1 = never heard
    r_birth: Any,  # [U] int32
    r_active: Any,  # [U] bool
    live: Optional[Any] = None,  # [N] bool — restrict to live nodes
) -> Dict[str, Any]:
    """The scalable engine's wavefront view: per active rumor slot, the
    first-heard tick distribution over nodes -> latency histogram +
    convergence curves (same JSON shape as ``dissemination_summary``)."""
    fh = np.asarray(first_heard)
    births = np.asarray(r_birth)
    active = np.asarray(r_active)
    live_mask = (
        np.ones(fh.shape[0], bool) if live is None else np.asarray(live)
    )
    lat_hist: Dict[int, int] = {}
    per_rumor: List[Dict[str, Any]] = []
    for r in np.nonzero(active)[0]:
        heard = fh[live_mask, r]
        heard = heard[heard >= 0]
        if heard.size == 0:
            continue
        birth = int(births[r])
        lats = heard - birth
        for v in lats.tolist():
            lat_hist[v] = lat_hist.get(v, 0) + 1
        ticks, counts = np.unique(heard, return_counts=True)
        per_rumor.append(
            {
                "slot": int(r),
                "birth": birth,
                "observers": int(heard.size),
                "convergence_tick": int(heard.max()),
                "convergence_latency": int(heard.max()) - birth,
                "convergence_curve": [
                    [int(t), int(c)]
                    for t, c in zip(ticks, np.cumsum(counts))
                ],
            }
        )
    return {
        "rumors": per_rumor,
        "latency_histogram_ticks": {
            str(k): v for k, v in sorted(lat_hist.items())
        },
    }


# -- sidecar schema ---------------------------------------------------------


def validate_event_stream(events: Iterable[Dict[str, Any]]) -> List[str]:
    """Schema check for a decoded event stream (the JSON sidecar form):
    required fields, known kinds, monotonically non-decreasing ticks."""
    problems: List[str] = []
    last_tick = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append("event %d: not an object" % i)
            continue
        for f in FIELDS:
            if f not in ev:
                problems.append("event %d: missing field %r" % (i, f))
        kind = ev.get("kind")
        if kind not in EVENT_KINDS:
            problems.append("event %d: unknown kind %r" % (i, kind))
        t = ev.get("tick")
        if not isinstance(t, int):
            problems.append("event %d: tick must be int" % i)
        elif last_tick is not None and t < last_tick:
            problems.append(
                "event %d: tick %d decreases (prev %d)" % (i, t, last_tick)
            )
        else:
            last_tick = t
    return problems
