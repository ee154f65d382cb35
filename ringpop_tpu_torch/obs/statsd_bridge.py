"""Statsd bridge: device-side tick counters -> reference statsd keys.

Host copy of ``ringpop_tpu/obs/statsd_bridge.py`` for the port: the same
key maps, prefix and emissions, call for call (tests/test_torch_statsd.py
holds the two bridges against each other).  ``emit_tick`` and
``emit_series`` also take the port's metrics NamedTuples of tensors, read
to the host in one transfer.

The reference emits a statsd stat on every protocol action through
``RingPop.stat()``'s per-key fq-name cache (index.js:527-541), with keys
namespaced ``ringpop.<host_port with . and : -> _>.<key>``
(index.js:162-164).  The simulation engines compute the same counters on
device (``TickMetrics``/``ScalableMetrics``); this bridge replays a
recorded tick (or a whole stacked series) onto a statsd client under the
reference's key names, so existing dashboards/collectors written against
ringpop-node keys read the simulated cluster unchanged.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import torch

from ringpop_tpu_torch.utils.host import to_host


def _host_metrics(metrics: Any) -> Any:
    """A metrics NamedTuple or dict with tensor leaves as numpy (one
    transfer); anything else as it is."""
    if hasattr(metrics, "_asdict"):
        metrics = metrics._asdict()
    if not isinstance(metrics, dict):
        return metrics
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return metrics
    out = dict(metrics)
    out.update(zip(keys, to_host([metrics[k] for k in keys])))
    return out

# TickMetrics / ScalableMetrics field -> (stat_type, reference key).
# Key names follow the reference emission sites: ping/ping-req send+recv
# (ping-sender.js, server/protocol/*.js), full-sync
# (dissemination.js:101-114), membership-update.<status>
# (on_membership_event.js), refuted-update (member.js:76-81), join
# completion (join-sender.js).  Fields with no reference analog (the
# sim-only diagnostics) ride under the "sim." namespace.
TICK_KEY_MAP: Dict[str, Tuple[str, str]] = {
    # full-fidelity engine (TickMetrics)
    "pings_sent": ("increment", "ping.send"),
    "pings_delivered": ("increment", "ping.recv"),
    "ping_reqs": ("increment", "ping-req.send"),
    "full_syncs": ("increment", "full-sync"),
    "changes_applied": ("increment", "changes.apply"),
    "suspects_marked": ("increment", "membership-update.suspect"),
    "faulties_marked": ("increment", "membership-update.faulty"),
    "refutes": ("increment", "refuted-update"),
    "piggyback_drops": ("increment", "changes.drop"),
    "full_sync_records": ("increment", "full-sync.records"),
    "ping_req_inconclusive": ("increment", "ping-req.inconclusive"),
    "join_merges": ("increment", "join.complete"),
    "distinct_checksums": ("gauge", "checksums.distinct"),
    "dirty_rows": ("gauge", "sim.checksum.dirty-rows"),
    "parity_overflow": ("increment", "sim.parity.overflow"),
    # scalable engine (ScalableMetrics) — shared fields above apply too
    "live_nodes": ("gauge", "num-members"),
    "active_rumors": ("gauge", "sim.rumors.active"),
    "suspects_published": ("increment", "membership-update.suspect"),
    "faulties_published": ("increment", "membership-update.faulty"),
    "refutes_published": ("increment", "refuted-update"),
    "leaves_published": ("increment", "membership-update.leave"),
    "rumors_retired": ("increment", "changes.drop"),
    "mean_heard_frac": ("gauge", "sim.rumors.mean-heard-frac"),
    # routing plane (RouteMetrics, models/route/plane.py) — mapped onto
    # the reference's requestProxy.* emission sites (send.js:91-208,
    # request-proxy/index.js:186-193); ring-maintenance diagnostics ride
    # the sim. namespace
    "route_queries": ("increment", "requestProxy.requests.outgoing"),
    "route_misroutes": ("increment", "sim.route.misroutes"),
    "route_reroute_local": ("increment", "requestProxy.retry.reroute.local"),
    "route_reroute_remote": (
        "increment",
        "requestProxy.retry.reroute.remote",
    ),
    "route_keys_diverged": ("increment", "requestProxy.retry.aborted"),
    "route_checksums_differ": ("increment", "requestProxy.checksumsDiffer"),
    "route_checksum_rejects": ("increment", "sim.route.checksum-rejects"),
    "route_ring_changed": ("increment", "sim.route.ring.changed-servers"),
    "route_ring_dirty_buckets": ("gauge", "sim.route.ring.dirty-buckets"),
    "route_ring_full_rebuilds": ("increment", "sim.route.ring.full-rebuilds"),
    "route_ring_points": ("gauge", "sim.route.ring.points"),
}

# Host-side phase timers (obs.perf DispatchTimer) -> reference TIMING
# keys (statsd ``|ms`` wire type).  The reference's getStats surfaces
# protocol-period duration, ping round-trip and checksum-computation
# timing histograms (SURVEY "Protocol timing profiling": protocol.delay
# / ping / compute-checksum); our host phases map onto them — one
# scanned/jitted tick IS one ping round, and the adaptive-period
# consumer emits the computed protocol.delay.  Unmapped phases ride
# ``sim.perf.<phase>``.
PERF_TIMER_KEYS: Dict[str, str] = {
    "tick": "ping",
    "scan": "ping",
    "checksum": "compute-checksum",
    "protocol_delay": "protocol.delay",
}

# Device-side latency-histogram tracks (ops.histogram, drained via
# obs.histograms) -> timing keys.  Reference analogs where they exist
# (requestProxy retry accounting, send.js:91-208); sim-only
# distributions ride the sim. namespace.  Values are in TICKS for the
# engine tracks (one tick == one protocol period) and counts for the
# routing tracks; the |ms wire type is kept so statsd dashboards
# aggregate them as timer series like the reference's.
HIST_TIMER_KEYS: Dict[str, str] = {
    # engines
    "rumor_age": "dissemination.rumor-age",
    "retired_age": "dissemination.rumor-retired-age",
    "suspicion_duration": "membership-update.suspicion-duration",
    "dirty_rows": "sim.checksum.dirty-rows.dist",
    # routing plane
    "retry_depth": "requestProxy.retry.depth",
    "reroute_hops": "requestProxy.hops",
    "dirty_buckets": "sim.route.ring.dirty-buckets.dist",
}

# Mesh exchange telemetry (obs.exchange_stats.drain over the device-side
# ExchangeMetrics counters): cross-shard SUMS emit as deltas
# under ``sharded.exchange.*`` — the mesh-collective analog of the
# reference's per-instance ringpop.<host_port>.* discipline; the shard
# count rides as a gauge.  Keys are keyed by ExchangeMetrics field name
# (lockstep pinned in tests/obs/test_statsd_bridge.py).
EXCHANGE_KEY_MAP: Dict[str, Tuple[str, str]] = {
    "ticks": ("increment", "sharded.exchange.ticks"),
    "a2a_pull": ("increment", "sharded.exchange.a2a.pull"),
    "a2a_push": ("increment", "sharded.exchange.a2a.push"),
    "fallback_pull": ("increment", "sharded.exchange.fallback.pull"),
    "fallback_push": ("increment", "sharded.exchange.fallback.push"),
    "pull_rows": ("increment", "sharded.exchange.rows.pull"),
    "push_rows": ("increment", "sharded.exchange.rows.push"),
    "dest_shards_pull": ("increment", "sharded.exchange.spread.pull"),
    "dest_shards_push": ("increment", "sharded.exchange.spread.push"),
    "wire_bytes_pull": ("increment", "sharded.exchange.wire-bytes.pull"),
    "wire_bytes_push": ("increment", "sharded.exchange.wire-bytes.push"),
    "shards": ("gauge", "sharded.exchange.shards"),
}

# Cap-utilization histogram tracks (EXCH_HIST_TRACKS) -> timer keys for
# emit_hist_summary (statsd ``|ms`` wire type, like HIST_TIMER_KEYS).
EXCHANGE_HIST_KEYS: Dict[str, str] = {
    "cap_util_pull": "sharded.exchange.cap-util.pull",
    "cap_util_push": "sharded.exchange.cap-util.push",
}

# Profiler trace harness (obs.xprof): capture wall time emits as a TIMER
# (|ms), the attributed-op count as a gauge.
XPROF_KEY_MAP: Dict[str, Tuple[str, str]] = {
    "wall_s": ("timing", "xprof.capture"),
    "ops": ("gauge", "xprof.ops"),
}

# Request-trace drain telemetry (obs.requests.drain over the device-side
# sampled per-request buffer): the drained record/drop volume
# and the sampled-subset counters emit as deltas under the sim.reqtrace
# namespace (the reference's per-request requestProxy stats are already
# claimed by the RouteMetrics rows above — these are the SAMPLED view);
# the configured sampling rate rides as a gauge.  Counter keys are keyed
# by obs.requests.COUNT_FIELDS name (lockstep pinned in
# tests/obs/test_statsd_bridge.py).
REQTRACE_KEY_MAP: Dict[str, Tuple[str, str]] = {
    "records": ("increment", "sim.reqtrace.records"),
    "drops": ("increment", "sim.reqtrace.drops"),
    "sample_log2": ("gauge", "sim.reqtrace.sample-log2"),
    "queries": ("increment", "sim.reqtrace.sampled.queries"),
    "misroutes": ("increment", "sim.reqtrace.sampled.misroutes"),
    "reroute_local": ("increment", "sim.reqtrace.sampled.reroute.local"),
    "reroute_remote": ("increment", "sim.reqtrace.sampled.reroute.remote"),
    "keys_diverged": ("increment", "sim.reqtrace.sampled.keys-diverged"),
    "checksums_differ": (
        "increment",
        "sim.reqtrace.sampled.checksums-differ",
    ),
    "checksum_rejects": (
        "increment",
        "sim.reqtrace.sampled.checksum-rejects",
    ),
}

# Sliding-window SLO plane (obs.slo.SLOWindowPlane): per-window rows
# emit under ``slo.<target>.<suffix>`` — windowed percentiles as TIMER
# samples (|ms wire type, matching the histogram-summary discipline),
# health ratios as gauges, breaches as counters.  Suffixes are keyed by
# slo.window row field (lockstep pinned in
# tests/obs/test_statsd_bridge.py).
SLO_KEY_MAP: Dict[str, Tuple[str, str]] = {
    "p50": ("timing", "p50"),
    "p95": ("timing", "p95"),
    "p99": ("timing", "p99"),
    "success_rate": ("gauge", "success-rate"),
    "burn_rate": ("gauge", "burn-rate"),
    "queries": ("increment", "window.queries"),
    "errors": ("increment", "window.errors"),
}
SLO_BREACH_KEY = "breach"

# Recovery-plane lifecycle counters (models/sim/recovery.py): emitted by
# CheckpointManager directly (they are per-event, not per-tick, so they
# ride their own map rather than TICK_KEY_MAP).  The reference has no
# checkpoint analog — a restarted ringpop rebuilds via join full-sync —
# so these live under the sim. namespace.
CKPT_KEY_MAP: Dict[str, str] = {
    "ckpt.saved": "sim.ckpt.saved",
    "ckpt.corrupt": "sim.ckpt.corrupt",
    "ckpt.resumed": "sim.ckpt.resumed",
    "ckpt.gc": "sim.ckpt.gc",
}


def stat_prefix(host_port: str) -> str:
    """The reference's stats identity: ``ringpop.<host_port>`` with
    non-alphanumeric separators flattened (index.js:162-164) — must stay
    in lockstep with ``Ringpop.__init__``."""
    return "ringpop.%s" % re.sub(r"[.:]", "_", host_port)


class StatsdBridge:
    """Emits tick counters through a ``Ringpop.stat``-style sink.

    Construct with a live facade (``StatsdBridge(ringpop=rp)`` — every
    emission rides ``rp.stat()`` and therefore its fq-key cache), or
    standalone with ``StatsdBridge(statsd=client, host_port="h:p")``,
    which replicates the same ``ringpop.<host_port>.`` scheme for
    simulation runs that have no facade.
    """

    def __init__(
        self,
        ringpop: Any = None,
        statsd: Any = None,
        host_port: Optional[str] = None,
        key_map: Optional[Dict[str, Tuple[str, str]]] = None,
    ):
        if ringpop is None and (statsd is None or host_port is None):
            raise ValueError("need ringpop=, or statsd= AND host_port=")
        self.key_map = dict(key_map or TICK_KEY_MAP)
        if ringpop is not None:
            self._stat = ringpop.stat
        else:
            prefix = stat_prefix(host_port)
            fq: Dict[str, str] = {}

            def _stat(stat_type: str, key: str, value: Any = None) -> None:
                fq_key = fq.get(key)
                if fq_key is None:
                    fq_key = fq[key] = "%s.%s" % (prefix, key)
                if stat_type == "increment":
                    statsd.increment(
                        fq_key, value if value is not None else 1
                    )
                elif stat_type == "gauge":
                    statsd.gauge(fq_key, value)
                elif stat_type == "timing":
                    statsd.timing(fq_key, value)

            self._stat = _stat

    def increment(self, key: str, value: int = 1) -> None:
        """Emit one COUNTER delta under the bridge's fq-key scheme — the
        public seam for driver-level aggregate counts (the mesh exchange
        drain's summed ``sharded.exchange.*`` deltas)."""
        self._stat("increment", key, int(value))

    def gauge(self, key: str, value) -> None:
        """Emit one gauge under the bridge's fq-key scheme — the public
        seam for driver-level one-shot stats (e.g. the mesh driver's
        ``sharded.exchange.*`` resolution note) so callers
        never reach into the internal ``_stat`` dispatch."""
        self._stat("gauge", key, value)

    def timing(self, key: str, value) -> None:
        """Emit one TIMER sample (statsd ``|ms`` wire type) under the
        bridge's fq-key scheme — the reference emits its protocol.delay
        / ping / compute-checksum timing histograms this way (getStats
        timing keys)."""
        self._stat("timing", key, value)

    def emit_hist_summary(
        self,
        summary: Dict[str, Dict[str, Any]],
        key_map: Optional[Dict[str, str]] = None,
    ) -> int:
        """Drained device-histogram summaries (obs.histograms.summarize)
        -> timer keys: per track, the p50/p95/p99 upper bounds emit as
        ``<key>.p50`` / ``.p95`` / ``.p99`` timing samples (empty tracks
        emit nothing).  Track names map through ``key_map`` (default
        HIST_TIMER_KEYS; unmapped tracks ride ``sim.hist.<track>``).
        Returns the number of emissions."""
        key_map = HIST_TIMER_KEYS if key_map is None else key_map
        emitted = 0
        for track, stats in summary.items():
            key = key_map.get(track, "sim.hist.%s" % track)
            for q in ("p50", "p95", "p99"):
                v = stats.get(q)
                if v is not None:
                    self.timing("%s.%s" % (key, q), v)
                    emitted += 1
        return emitted

    def emit_exchange_drain(
        self,
        tot: Dict[str, Any],
        key_map: Optional[Dict[str, Tuple[str, str]]] = None,
    ) -> int:
        """One drained exchange-telemetry window's cross-shard totals
        (obs.exchange_stats.totals) -> ``sharded.exchange.*``: counters
        emit only when nonzero (statsd increments are deltas), the shard
        count always emits as a gauge.  Returns the number of
        emissions."""
        key_map = EXCHANGE_KEY_MAP if key_map is None else key_map
        emitted = 0
        for field, value in tot.items():
            mapped = key_map.get(field)
            if mapped is None:
                continue
            stat_type, key = mapped
            if stat_type == "increment":
                if value:
                    self.increment(key, int(value))
                    emitted += 1
            else:
                self._stat(stat_type, key, value)
                emitted += 1
        return emitted

    def emit_reqtrace_drain(
        self,
        row: Dict[str, Any],
        key_map: Optional[Dict[str, Tuple[str, str]]] = None,
    ) -> int:
        """One drained request-trace window (obs.requests.drain_row) ->
        ``sim.reqtrace.*``: record/drop volume and the sampled-subset
        counters emit only when nonzero (statsd increments are deltas);
        the sampling rate always emits as a gauge.  Returns the number
        of emissions."""
        key_map = REQTRACE_KEY_MAP if key_map is None else key_map
        flat = dict(row)
        flat.update(flat.pop("counts", {}) or {})
        emitted = 0
        for field, value in flat.items():
            mapped = key_map.get(field)
            if mapped is None:
                continue
            stat_type, key = mapped
            if stat_type == "increment":
                if value:
                    self.increment(key, int(value))
                    emitted += 1
            else:
                self._stat(stat_type, key, value)
                emitted += 1
        return emitted

    def emit_slo_window(
        self,
        row: Dict[str, Any],
        key_map: Optional[Dict[str, Tuple[str, str]]] = None,
    ) -> int:
        """One ``slo.window`` row (obs.slo.SLOWindowPlane.window_row) ->
        ``slo.<target>.<suffix>``: windowed percentiles as timer samples
        (empty windows skip them), success/burn rates as gauges, window
        query/error volume as counter deltas.  Returns the number of
        emissions."""
        key_map = SLO_KEY_MAP if key_map is None else key_map
        prefix = "slo.%s" % row["target"]
        emitted = 0
        for field, (stat_type, suffix) in key_map.items():
            value = row.get(field)
            if value is None:
                continue
            key = "%s.%s" % (prefix, suffix)
            if stat_type == "increment":
                if value:
                    self.increment(key, int(value))
                    emitted += 1
            else:
                self._stat(stat_type, key, value)
                emitted += 1
        return emitted

    def emit_slo_breach(self, target: str) -> None:
        """One SLO breach -> ``slo.<target>.breach`` counter tick."""
        self.increment("slo.%s.%s" % (target, SLO_BREACH_KEY))

    def emit_tick(self, row: Any) -> int:
        """One tick's metrics (NamedTuple or dict).  Counters emit only
        when nonzero (statsd increments are deltas); gauges always emit.
        A [B]-vector value (the vmapped driver's per-cluster axis) is
        summed for counters — aggregate events across the batch — and
        skipped for gauges, which have no single-key meaning there.
        Returns the number of emissions."""
        row = _host_metrics(row)
        emitted = 0
        for field, value in row.items():
            mapped = self.key_map.get(field)
            if mapped is None:
                continue
            stat_type, key = mapped
            if getattr(value, "ndim", 0) > 0:
                if stat_type != "increment":
                    continue
                value = value.sum()
            if hasattr(value, "item"):
                value = value.item()
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                continue
            if stat_type == "increment":
                if value:
                    self._stat("increment", key, int(value))
                    emitted += 1
            else:
                self._stat(stat_type, key, value)
                emitted += 1
        return emitted

    def emit_series(self, metrics: Any) -> int:
        """A stacked [T]- (or vmapped [T, B]-) series, as the scan
        drivers return: emits every tick in order.  Returns total
        emissions."""
        from ringpop_tpu_torch.obs.recorder import iter_tick_rows

        return sum(self.emit_tick(row) for row in iter_tick_rows(_host_metrics(metrics)))
