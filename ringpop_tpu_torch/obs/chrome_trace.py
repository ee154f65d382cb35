"""Chrome-trace (Perfetto-loadable) JSON export of flight-recorder runs.

A copy of ``ringpop_tpu/obs/chrome_trace.py``: export, validation, the
sidecar writer and the host-timeline merge (:func:`add_host_timeline`,
which reads an ``obs.perf.DispatchTimer``).

Turns a decoded flight-recorder event stream (obs/events.py) into the
Trace Event Format consumed by ``chrome://tracing`` and
https://ui.perfetto.dev — one process for the simulated cluster, one
track (thread) per node:

- **status-transition spans**: each node's own liveness story (its view
  of ITSELF: alive / suspect / faulty / leave) renders as complete
  ``"X"`` span events on its track, so a churn wave reads as colored
  bands.
- **rumor flow arrows**: each rumor's dissemination renders as a flow
  (``"s"``/``"t"`` events, one flow id per rumor) from the origin node
  to every node's first-heard adoption — the epidemic wavefront as
  literal arrows across tracks.
- **instant events**: suspect/faulty verdicts, refutes, full syncs and
  joins as ``"i"`` instants; pings are opt-in (``include_pings``) —
  every tick emits N of them and Perfetto renders the rest fine without.

Times: one engine tick is one protocol period (``period_ms``), so
``ts = tick * period_ms * 1000`` microseconds.  The exporter is pure
host-side JSON assembly — no jax, no engine imports.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ringpop_tpu_torch.obs import events as ev

STATUS_NAMES = ("alive", "suspect", "faulty", "leave")

# stable Perfetto color names per status span
_STATUS_COLORS = {
    "alive": "good",
    "suspect": "bad",
    "faulty": "terrible",
    "leave": "grey",
}


def _ts(tick: int, period_ms: int) -> int:
    return int(tick) * int(period_ms) * 1000


def _status_name(code: int) -> str:
    return (
        STATUS_NAMES[code]
        if 0 <= code < len(STATUS_NAMES)
        else "status-%d" % code
    )


def export_chrome_trace(
    events: Any,
    n: int,
    period_ms: int = 200,
    addresses: Optional[List[str]] = None,
    include_pings: bool = False,
    pid: int = 1,
) -> Dict[str, Any]:
    """Decoded events -> a Trace Event Format dict (``json.dump`` ready).

    ``events`` accepts anything :func:`obs.events._as_arrays` does —
    the decoded dict list, the columnar arrays, or a raw (buf, head)
    pair."""
    arrs = ev._as_arrays(events)
    ticks = arrs["tick"]
    kinds = arrs["kind"]
    observers = arrs["observer"]
    subjects = arrs["subject"]
    new_status = arrs["new_status"]
    incs = arrs["inc"]
    auxes = arrs["aux"]
    out: List[Dict[str, Any]] = []

    # track metadata: one named thread per node
    out.append(
        {
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": "ringpop-sim cluster (n=%d)" % n},
        }
    )
    for i in range(n):
        label = addresses[i] if addresses else "node %d" % i
        out.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": i,
                "name": "thread_name",
                "args": {"name": label},
            }
        )

    max_tick = int(ticks.max()) if len(ticks) else 0
    end_ts = _ts(max_tick + 1, period_ms)

    # -- per-node self-status spans ------------------------------------
    # a node's own story: status events where observer == subject, plus
    # refutes (self re-assert alive).  Each transition closes the
    # previous span and opens the next; every node starts alive at 0.
    transitions: Dict[int, List] = {i: [(0, 0)] for i in range(n)}
    order = ticks.argsort(kind="stable")
    for i in order:
        k = int(kinds[i])
        o = int(observers[i])
        if o < 0 or o >= n:
            continue
        if k == ev.EV_STATUS and int(subjects[i]) == o:
            transitions[o].append((int(ticks[i]), int(new_status[i])))
        elif k == ev.EV_REFUTE:
            transitions[o].append((int(ticks[i]), 0))
    for node, trs in transitions.items():
        for j, (t0, status) in enumerate(trs):
            # collapse repeated same-status transitions
            if j > 0 and trs[j - 1][1] == status:
                continue
            t1 = next(
                (t for t, s in trs[j + 1 :] if s != status), max_tick + 1
            )
            name = _status_name(status)
            out.append(
                {
                    "ph": "X",
                    "pid": pid,
                    "tid": node,
                    "ts": _ts(t0, period_ms),
                    "dur": max(_ts(t1, period_ms) - _ts(t0, period_ms), 1),
                    "cat": "status",
                    "name": name,
                    "cname": _STATUS_COLORS.get(name),
                    "args": {"status": name},
                }
            )

    # -- rumor flow arrows ---------------------------------------------
    wavefronts = ev.rumor_wavefronts(arrs)
    flow_id = 0
    for rid, wf in sorted(wavefronts.items()):
        if len(wf["first_heard"]) < 2:
            continue
        flow_id += 1
        subject, status, inc = rid
        name = "rumor %s(%d)@%d" % (_status_name(status), subject, inc)
        origin = min(wf["first_heard"], key=lambda o: (wf["first_heard"][o], o))
        out.append(
            {
                "ph": "s",
                "pid": pid,
                "tid": origin,
                "ts": _ts(wf["birth"], period_ms),
                "cat": "rumor",
                "name": name,
                "id": flow_id,
            }
        )
        for o, t in sorted(wf["first_heard"].items()):
            if o == origin:
                continue
            out.append(
                {
                    "ph": "t",
                    "pid": pid,
                    "tid": o,
                    "ts": _ts(t, period_ms),
                    "cat": "rumor",
                    "name": name,
                    "id": flow_id,
                }
            )

    # -- protocol instants ---------------------------------------------
    _INSTANT = {
        ev.EV_SUSPECT: "suspect",
        ev.EV_FAULTY: "faulty",
        ev.EV_FULL_SYNC: "full-sync",
        ev.EV_REFUTE: "refute",
        ev.EV_JOIN: "join",
    }
    if include_pings:
        _INSTANT = dict(_INSTANT)
        _INSTANT[ev.EV_PING] = "ping"
    for i in range(len(ticks)):
        k = int(kinds[i])
        label = _INSTANT.get(k)
        if label is None:
            continue
        o = int(observers[i])
        if o < 0 or o >= n:
            continue
        out.append(
            {
                "ph": "i",
                "pid": pid,
                "tid": o,
                "ts": _ts(int(ticks[i]), period_ms),
                "s": "t",  # thread-scoped instant
                "cat": "protocol",
                "name": "%s(%d)" % (label, int(subjects[i])),
                "args": {
                    "subject": int(subjects[i]),
                    "inc": int(incs[i]),
                    "aux": int(auxes[i]),
                },
            }
        )

    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "ringpop_tpu_torch.obs.chrome_trace",
            "n": n,
            "period_ms": period_ms,
            "end_ts_us": end_ts,
        },
    }


HOST_PID = 0  # the host-timeline process id (cluster tracks ride pid=1)


def add_host_timeline(
    trace: Dict[str, Any],
    timer,
    label: str = "host dispatch",
) -> Dict[str, Any]:
    """Merge a DispatchTimer's host-timeline track (obs.perf) into an
    exported flight trace IN PLACE: one ``pid=HOST_PID`` process with
    the per-phase dispatch spans, so Perfetto shows wall-clock host
    phases above the per-node protocol tracks.  Host spans are
    wall-relative (timer birth = 0) while the cluster tracks are
    tick-relative — the two clocks share an origin, not a rate, which
    is exactly what a dispatch-vs-protocol timeline wants to show.
    Returns the trace dict."""
    evs = trace.setdefault("traceEvents", [])
    evs.append(
        {
            "ph": "M",
            "pid": HOST_PID,
            "tid": 0,
            "name": "process_name",
            "args": {"name": label},
        }
    )
    evs.extend(timer.chrome_trace_events(pid=HOST_PID, tid=0))
    return trace


_KNOWN_PHASES = {"B", "E", "X", "i", "I", "M", "s", "t", "f", "C"}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Minimal Trace Event Format schema check; returns problems (empty
    == valid).  Accepts the dict form or a JSON string/loaded list."""
    problems: List[str] = []
    if isinstance(trace, str):
        try:
            trace = json.loads(trace)
        except ValueError as e:
            return ["not JSON: %s" % e]
    if isinstance(trace, dict):
        evs = trace.get("traceEvents")
        if not isinstance(evs, list):
            return ["object form must carry a traceEvents list"]
    elif isinstance(trace, list):
        evs = trace
    else:
        return ["trace must be an object or array"]
    open_flows = set()
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append("event %d: not an object" % i)
            continue
        ph = e.get("ph")
        if ph not in _KNOWN_PHASES:
            problems.append("event %d: unknown phase %r" % (i, ph))
            continue
        if not isinstance(e.get("pid"), int) or not isinstance(
            e.get("tid"), int
        ):
            problems.append("event %d: pid/tid must be ints" % i)
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append("event %d: bad ts %r" % (i, ts))
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur <= 0:
                problems.append("event %d: X event needs dur > 0" % i)
        if ph in ("s", "t", "f"):
            fid = e.get("id")
            if fid is None:
                problems.append("event %d: flow event needs an id" % i)
            elif ph == "s":
                open_flows.add(fid)
            elif fid not in open_flows:
                problems.append(
                    "event %d: flow step id %r has no start" % (i, fid)
                )
        if ph == "M" and e.get("name") not in (
            "process_name",
            "thread_name",
            "process_labels",
            "thread_sort_index",
            "process_sort_index",
        ):
            problems.append(
                "event %d: unknown metadata name %r" % (i, e.get("name"))
            )
    return problems


def write_chrome_trace(trace: Dict[str, Any], path: str) -> str:
    """Validate + write; raises on schema problems so a broken exporter
    can never land an artifact."""
    problems = validate_chrome_trace(trace)
    if problems:
        raise ValueError(
            "chrome trace failed validation:\n" + "\n".join(problems)
        )
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(trace, fh, sort_keys=True)
    return path
