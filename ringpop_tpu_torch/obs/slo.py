"""Sliding-window SLO plane over the routing plane's drained telemetry.

A served RoutedStorm needs more than cumulative
counters: an operator asks "what is the p99 and the success rate over
the LAST window, and how fast am I burning the error budget?"  This
module answers with the standard serving-stack machinery:

- **sliding window**: a ring buffer of per-window deltas — each
  ``observe()`` pushes one drained window (log2 histogram bucket-count
  delta + query/error counter deltas) and evicts the oldest once
  ``window_len`` windows are held.  Bucket counts are additive, so the
  sliding totals are exactly the pooled observations of the covered
  ticks — windowed percentiles come from the same nearest-rank
  extraction the cumulative drain uses (obs.histograms.percentile).
- **declarative SLO targets** (:class:`SLOTarget`): a success-rate
  objective, an optional p99 ceiling, and a burn-rate alert threshold.
- **error-budget burn rate**: ``(errors/queries) / (1 - objective)`` —
  1.0 means the budget is being consumed exactly at the sustainable
  rate; an SRE-style fast-burn alert fires at ``burn_alert``.
- **schema-gated rows**: every ``observe()`` emits one ``slo.window``
  event row on the attached recorder (field set validated by
  scripts/check_metrics_schema.py); a breach additionally emits
  ``slo.breach`` naming every violated clause.
- **consumer hook**: :class:`SLOBackpressure`, the
  ``AdaptiveProtocolPeriod``-style consumer — turns the burn rate into
  a protocol-period/backpressure factor so a serving loop has
  its sensor ready (off by default: nothing constructs one unless
  asked).

Feeding it: read the route histogram every W ticks, then drain it with
reset=True (the counts read ARE the window delta), and pass the
per-window RouteMetrics counter deltas of the port's ``RoutedStorm.run``.

A copy of ``ringpop_tpu/obs/slo.py`` over the port's
``ops.histogram.NBUCKETS``, ``obs.histograms.percentile`` and
``models.route.plane.ROUTE_HIST_TRACKS``.  ``observe_route_window`` reads
the histogram through ``obs.histograms.host_counts``, so it takes the
port's ``RouteState.hist`` (int32 tensors of uint32 bits, on either
device) as well as a numpy array.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from ringpop_tpu_torch.obs import histograms as oh
from ringpop_tpu_torch.ops import histogram as hg

WINDOW_QS = (50, 95, 99)


class SLOTarget(NamedTuple):
    """One declarative SLO: a named objective over a request stream.

    ``success_objective`` is the fraction of requests that must succeed
    (errors are whatever counter the feeder passes as ``errors``);
    ``p99_max`` (optional) caps the windowed p99 in track value units;
    ``burn_alert`` is the error-budget burn-rate multiple that fires a
    breach even while the success rate still clears the objective (the
    SRE fast-burn alert)."""

    name: str = "route"
    success_objective: float = 0.999
    p99_max: Optional[int] = None
    burn_alert: float = 2.0


def burn_rate(
    errors: int, queries: int, success_objective: float
) -> float:
    """Error-budget burn rate: observed error fraction over the budget
    fraction ``1 - objective``.  1.0 = consuming the budget exactly at
    the sustainable rate; 0 queries burns nothing; a 100% objective has
    zero budget, so any error burns at +inf."""
    if queries <= 0 or errors <= 0:
        return 0.0
    frac = errors / queries
    budget = 1.0 - success_objective
    if budget <= 0.0:
        return float("inf")
    return frac / budget


class SLOWindowPlane:
    """Ring-buffered sliding-window SLO evaluator (one histogram track
    + one error counter against one :class:`SLOTarget`)."""

    def __init__(
        self,
        target: SLOTarget = SLOTarget(),
        window_len: int = 8,
        recorder=None,
        statsd=None,
        consumer=None,
    ):
        if window_len < 1:
            raise ValueError("window_len must be >= 1")
        self.target = target
        # the ring buffer: (ticks, bucket-count delta, queries, errors)
        self._ring: deque = deque(maxlen=window_len)
        self.recorder = recorder
        self.statsd = statsd
        self.consumer = consumer
        self.breaches = 0

    # -- feeding ----------------------------------------------------------

    def observe(
        self,
        tick: int,
        counts_delta: Any,  # [NBUCKETS] — one window's bucket deltas
        queries: int,
        errors: int,
        ticks: int = 1,
    ) -> Dict[str, Any]:
        """Push one drained window's deltas; evaluate the sliding
        window; emit ``slo.window`` (and, on a breach, ``slo.breach``)
        rows; feed the consumer hook.  Returns the window row."""
        counts = np.asarray(counts_delta, np.int64).reshape(-1)
        if counts.shape[0] != hg.NBUCKETS:
            raise ValueError(
                "counts_delta must be one [%d] bucket-count window, "
                "got %r" % (hg.NBUCKETS, counts.shape)
            )
        self._ring.append((int(ticks), counts, int(queries), int(errors)))
        row = self.window_row(tick)
        if self.recorder is not None:
            self.recorder.record_event("slo.window", **row)
        if self.statsd is not None:
            self.statsd.emit_slo_window(row)
        if row["breach"]:
            self.breaches += 1
            breach = {
                "target": row["target"],
                "tick": row["tick"],
                "window_ticks": row["window_ticks"],
                "reason": row["breach_reason"],
                "burn_rate": row["burn_rate"],
                "success_rate": row["success_rate"],
                "p99": row["p99"],
            }
            if self.recorder is not None:
                self.recorder.record_event("slo.breach", **breach)
            if self.statsd is not None:
                self.statsd.emit_slo_breach(row["target"])
        if self.consumer is not None:
            self.consumer.update(row)
        return row

    def observe_route_window(
        self,
        tick: int,
        hist,  # [len(ROUTE_HIST_TRACKS), NBUCKETS] — drained window
        rm,  # RouteMetrics window stack (per-tick [T] arrays)
        track: str = "retry_depth",
    ) -> Dict[str, Any]:
        """Convenience feeder for the routing plane: one drained route
        histogram window (the counts BETWEEN resets — drain with
        reset=True each window) + the same window's RouteMetrics stack.
        Errors = retried-or-aborted requests (misroutes + consistency
        rejects + keys-diverged aborts — the requestProxy failure
        surface)."""
        from ringpop_tpu_torch.models.route.plane import ROUTE_HIST_TRACKS

        arr = oh.host_counts(hist)
        counts = arr[ROUTE_HIST_TRACKS.index(track)]
        md = rm._asdict() if hasattr(rm, "_asdict") else dict(rm)
        queries = int(np.asarray(md["route_queries"]).sum())
        errors = int(
            np.asarray(md["route_misroutes"]).sum()
            + np.asarray(md["route_checksum_rejects"]).sum()
            + np.asarray(md["route_keys_diverged"]).sum()
        )
        ticks = int(np.asarray(md["route_queries"]).reshape(-1).shape[0])
        return self.observe(tick, counts, queries, errors, ticks=ticks)

    # -- evaluation -------------------------------------------------------

    def window_counts(self) -> np.ndarray:
        """[NBUCKETS] pooled bucket counts over the held windows."""
        out = np.zeros(hg.NBUCKETS, np.int64)
        for _, counts, _, _ in self._ring:
            out += counts
        return out

    def window_row(self, tick: int) -> Dict[str, Any]:
        """Evaluate the current sliding window into one ``slo.window``
        row: nearest-rank percentiles (conservative bucket upper
        bounds, obs.histograms semantics), success rate, burn rate,
        and the breach verdict with its reasons."""
        t = self.target
        window_ticks = sum(w[0] for w in self._ring)
        queries = sum(w[2] for w in self._ring)
        errors = sum(w[3] for w in self._ring)
        counts = self.window_counts()
        row: Dict[str, Any] = {
            "target": t.name,
            "tick": int(tick),
            "window_ticks": int(window_ticks),
            "windows": len(self._ring),
            "queries": int(queries),
            "errors": int(errors),
        }
        for q in WINDOW_QS:
            p = oh.percentile(counts, q)
            row["p%d" % q] = None if p is None else p["value"]
        success = 1.0 if queries <= 0 else 1.0 - errors / queries
        burn = burn_rate(errors, queries, t.success_objective)
        row["success_rate"] = success
        row["burn_rate"] = burn
        reasons: List[str] = []
        if queries > 0 and success < t.success_objective:
            reasons.append("success-rate")
        if t.p99_max is not None and row["p99"] is not None:
            if row["p99"] > t.p99_max:
                reasons.append("p99")
        if burn >= t.burn_alert:
            reasons.append("burn-rate")
        row["breach"] = bool(reasons)
        row["breach_reason"] = ",".join(reasons)
        return row


# -- the consumer hook: burn-rate backpressure ------------------------------


class SLOBackpressure:
    """``AdaptiveProtocolPeriod``-style consumer of ``slo.window`` rows:
    scales a base protocol period by the error-budget burn rate while
    the target is breaching (more backpressure = longer period = less
    offered load), snapping back to the base once the window clears —
    the sensor-to-actuator seam a serving loop plugs
    into.  ``factor()`` is clamped to [1, max_factor]."""

    def __init__(
        self, base_period_ms: float = 200.0, max_factor: float = 8.0
    ):
        if max_factor < 1.0:
            raise ValueError("max_factor must be >= 1")
        self.base_period_ms = float(base_period_ms)
        self.max_factor = float(max_factor)
        self._factor = 1.0

    def update(self, row: Dict[str, Any]) -> float:
        """Feed one window row; returns the new period in ms."""
        if row.get("breach"):
            burn = float(row.get("burn_rate") or 1.0)
            self._factor = min(max(burn, 1.0), self.max_factor)
        else:
            self._factor = 1.0
        return self.period_ms()

    def factor(self) -> float:
        return self._factor

    def period_ms(self) -> float:
        return self.base_period_ms * self._factor


__all__ = [
    "SLOBackpressure",
    "SLOTarget",
    "SLOWindowPlane",
    "WINDOW_QS",
    "burn_rate",
]
