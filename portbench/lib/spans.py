"""A traced window put down to the program's own spans.

The program logs its spans (``ringpop_tpu_torch.obs.perf``: driver calls,
engine phases, the blocking reads) while ``torch.profiler`` records the
card's activity: the device records and, on the host, the CUDA runtime
calls that issued them.  Both stamp Unix-epoch ns.  A device record is
paired with its runtime call by the CUPTI correlation id, never by time
(a busy card runs a kernel long after the host issued it); the runtime
call is then put in the innermost span that holds it.  An idle gap of
the card goes to the innermost span holding its midpoint, beside the
runtime call holding it (``lib/trace.py``'s label).

A span is ``(name, start_ns, end_ns, parent, shard)``, the rows of
``DispatchTimer.log``; a device record ``(name, start_ns, dur_ns,
correlation)``; a runtime record ``(start_ns, end_ns, name, correlation)``.
Every reader returns None where there is no span log or no tick.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

# the program's span of a blocking device-to-host read
WAIT = "wait"


def _ids(e):
    """The correlation ids a kineto record carries (0 where it has none)."""
    return (int(getattr(e, "correlation_id", lambda: 0)()),
            int(getattr(e, "linked_correlation_id", lambda: 0)()))


def records(events):
    """Device and runtime records of ``kineto_results.events()``: each
    device record's correlation is whichever of its two ids names a
    runtime record (the one that pairs more records wins)."""
    from torch.autograd import DeviceType

    from portbench.lib.trace import _annotation, _start_ns

    device, host = [], []
    for e in events:
        t0, dur = _start_ns(e), int(e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if dur > 0 and not _annotation(e):
                device.append((e.name(), t0, dur, _ids(e)))
        else:
            host.append((t0, t0 + dur, e.name(), _ids(e)[0]))
    known = {h[3] for h in host if h[3]}
    pick = max((0, 1), key=lambda k: sum(d[3][k] in known for d in device))
    return ([(n, t0, dur, ids[pick]) for n, t0, dur, ids in device],
            sorted(host, key=lambda h: h[0]))


class _Innermost:
    """The innermost span holding each of a sorted run of times: a sweep
    over the spans' starts and ends (spans of one shard body nest; those
    of other bodies may overlap them, and the latest start wins)."""

    def __init__(self, log):
        self._log = log
        self._order = sorted(range(len(log)), key=lambda i: log[i][1])
        self._next = 0
        self._open = []  # indices, by start

    def at(self, t: int) -> int:
        log = self._log
        while self._next < len(self._order) and log[self._order[self._next]][1] <= t:
            self._open.append(self._order[self._next])
            self._next += 1
        self._open = [i for i in self._open if log[i][2] is None or log[i][2] >= t]
        return self._open[-1] if self._open else -1


def _innermost(log, times):
    """``{time: span index or -1}`` for each time."""
    sweep = _Innermost(log)
    return {t: sweep.at(t) for t in sorted(set(times))}


class SpanTrace:
    """The window's device records and idle gaps by span."""

    def __init__(self, device, host, log, counters=None):
        self.log = list(log)
        self.counters = dict(counters or {})
        self.device = sorted(device, key=lambda r: r[1])
        self._host = host
        self._host_starts = [h[0] for h in host]
        by_corr = {h[3]: h for h in host if h[3]}
        self.runtime = [by_corr.get(r[3]) for r in self.device]
        where = _innermost(self.log, [h[0] for h in self.runtime if h is not None])
        # each device record's span (-1: outside every span, -2: unpaired)
        self.span_of = [-2 if h is None else where[h[0]] for h in self.runtime]
        self.gaps = self._gaps()
        mids = _innermost(self.log, [(a + b) // 2 for a, b in self.gaps])
        self.gap_span = [mids[(a + b) // 2] for a, b in self.gaps]

    @classmethod
    def from_profiler(cls, prof, log, counters=None):
        device, host = records(prof.profiler.kineto_results.events())
        return cls(device, host, log, counters)

    # -- the card's side ----------------------------------------------------

    def _gaps(self):
        gaps, end = [], None
        for _, t0, dur, _ in self.device:
            if end is not None and t0 > end:
                gaps.append((end, t0))
            end = t0 + dur if end is None else max(end, t0 + dur)
        return gaps

    def ancestors(self, i: int):
        """Names of span ``i`` and of every span above it, innermost first."""
        out = []
        while i >= 0:
            out.append(self.log[i][0])
            i = self.log[i][3]
        return out

    def device_ns(self, under=None) -> int:
        """Device ns of the records launched inside a span named in
        ``under`` (the span itself or one above it); all paired records
        inside any span with ``under`` None."""
        total = 0
        for (_, _, dur, _), i in zip(self.device, self.span_of):
            if i >= 0 and (under is None or set(self.ancestors(i)) & set(under)):
                total += dur
        return total

    def attributed_share(self):
        """Share of the device records' time launched inside a span."""
        total = sum(r[2] for r in self.device)
        return None if not total or not self.log else self.device_ns() / total

    def unpaired(self) -> int:
        return sum(i == -2 for i in self.span_of)

    def _host_label(self, mid: int) -> str:
        i = bisect.bisect_right(self._host_starts, mid)
        for j in range(i - 1, max(-1, i - 8), -1):
            if self._host[j][1] >= mid:
                return self._host[j][2]
        return "host"

    def idle_gaps(self, top: int = 10):
        """Idle seconds by label: ``<span>|<runtime call or host>`` inside
        a span, the runtime call (or ``host``) outside every span."""
        per = defaultdict(int)
        for (a, b), i in zip(self.gaps, self.gap_span):
            label = self._host_label((a + b) // 2)
            if i >= 0:
                label = "%s|%s" % (self.log[i][0], label)
            per[label[:64]] += b - a
        return [[n, ns / 1e9] for n, ns in sorted(per.items(), key=lambda kv: -kv[1])[:top]]

    def idle_ns(self, bare: bool = False) -> int:
        """Idle ns of the card; with ``bare`` only the gaps outside every
        span that no runtime call holds (plain ``host``)."""
        return sum(b - a for (a, b), i in zip(self.gaps, self.gap_span)
                   if not bare or (i < 0 and self._host_label((a + b) // 2) == "host"))

    def launch_spans(self, kernel: str):
        """Names of the innermost spans whose runtime calls launched the
        records whose name holds ``kernel`` (None: launched outside every
        span or not paired)."""
        return [self.log[i][0] if i >= 0 else None
                for (n, _, _, _), i in zip(self.device, self.span_of) if kernel in n]

    # -- the host's side ----------------------------------------------------

    def host_ns(self, name: str, less=None) -> int:
        """Host ns inside spans named ``name``, less the time of their
        descendants named ``less``."""
        children = defaultdict(list)
        for i, rec in enumerate(self.log):
            children[rec[3]].append(i)

        def dur(i):
            return (self.log[i][2] or self.log[i][1]) - self.log[i][1]

        def nested(i):
            return sum(dur(c) if self.log[c][0] == less else nested(c) for c in children[i])

        return sum(dur(i) - (nested(i) if less else 0)
                   for i, rec in enumerate(self.log) if rec[0] == name)

    def table(self, ticks: int):
        """Per span name: calls, host self ms a tick (less the spans
        inside it) and device ms a tick of the records launched in it."""
        inner = defaultdict(int)
        for rec in self.log:
            if rec[3] >= 0 and rec[2] is not None:
                inner[rec[3]] += rec[2] - rec[1]
        out = defaultdict(lambda: {"calls": 0, "host_self_ms": 0.0, "device_ms": 0.0})
        for i, rec in enumerate(self.log):
            row = out[rec[0]]
            row["calls"] += 1
            row["host_self_ms"] += ((rec[2] or rec[1]) - rec[1] - inner[i]) / 1e6 / ticks
        for (_, _, dur, _), i in zip(self.device, self.span_of):
            if i >= 0:
                out[self.log[i][0]]["device_ms"] += dur / 1e6 / ticks
        return dict(out)


# -- the per-layer quantities the spans and counters give -------------------


def _per_tick(value, ticks):
    return None if value is None or not ticks else value / ticks


def checksum_device_ms_per_tick(st: SpanTrace, ticks: int):
    """Device ms a tick launched inside ``checksum`` and ``checksum.mid``
    (the encode and the hash below them included)."""
    if not st.log:
        return None
    return _per_tick(st.device_ns(("checksum", "checksum.mid")) / 1e6, ticks)


def hashed_rows_dirty_pct(st: SpanTrace):
    """100 x the rows whose view changed over the rows hashed."""
    hashed, dirty = st.counters.get("rows_hashed"), st.counters.get("rows_dirty")
    if not st.log or not hashed or dirty is None:
        return None
    return 100.0 * dirty / hashed


def host_issue_ms_per_tick(st: SpanTrace, ticks: int, tick: str = "storm.tick"):
    """Host ms a tick inside the storm's tick span, less its waits."""
    if not st.log:
        return None
    return _per_tick(st.host_ns(tick, less=WAIT) / 1e6, ticks)


def host_wait_ms_per_tick(st: SpanTrace, ticks: int):
    """Host ms a tick inside every ``wait`` span."""
    if not st.log:
        return None
    return _per_tick(st.host_ns(WAIT) / 1e6, ticks)


def ring_device_ms_per_tick(st: SpanTrace, ticks: int):
    """Device ms a tick launched inside ``storm.ring``."""
    if not st.log:
        return None
    return _per_tick(st.device_ns(("storm.ring",)) / 1e6, ticks)
