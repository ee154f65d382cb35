"""Prometheus text exposition (text format 0.0.4) of the simulation
drivers' device telemetry and recorded runs.

A copy of ``ringpop_tpu/obs/prometheus.py``: the minimal purpose-built
writer (:class:`PromWriter`, with native histogram
families over the log2 buckets of ``ops.histogram``),
:func:`render_device_histograms` (a drained ``[tracks, NBUCKETS]`` bank),
:func:`render_slo_plane` (an ``obs.slo.SLOWindowPlane``) and
:func:`render_tick_series` (a stacked metrics series).  The bucket banks
are read through ``obs.histograms.host_counts``, so the port's int32
tensors of uint32 bits render as the JAX package's uint32 arrays do;
and :func:`render_ringpop_metrics` (the ``/admin/metrics`` body of a
live node, ``api/server.py``: meters, membership, ring, gossip and
dissemination state of a ``Ringpop`` facade).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def _escape_label(v: Any) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _escape_help(v: Any) -> str:
    """HELP-line escaping per the exposition format 0.0.4: backslash and
    newline only (double quotes are NOT escaped outside label values).
    Unescaped, a newline in help text would split the line and corrupt
    every sample after it."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


class PromWriter:
    """Accumulates samples; renders the exposition text.

    Samples are buffered per metric family and rendered grouped (HELP,
    TYPE, then every sample of that family), in first-seen family order:
    the text format requires all lines of one metric to form a single
    group, even when the caller interleaves families (e.g. a per-plane
    loop emitting two families per iteration)."""

    def __init__(self) -> None:
        self._families: Dict[str, Dict[str, Any]] = {}
        self._order: List[str] = []

    def sample(
        self,
        name: str,
        value: Any,
        help_: Optional[str] = None,
        type_: str = "gauge",
        labels: Optional[Dict[str, Any]] = None,
    ) -> None:
        if value is None:
            return
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = {
                "help": help_,
                "type": type_,
                "samples": [],
            }
            self._order.append(name)
        label_str = ""
        if labels:
            label_str = "{%s}" % ",".join(
                '%s="%s"' % (k, _escape_label(v))
                for k, v in sorted(labels.items())
            )
        fam["samples"].append(
            "%s%s %s" % (name, label_str, _fmt_value(value))
        )

    def histogram(
        self,
        name: str,
        bucket_counts: Any,
        help_: Optional[str] = None,
        labels: Optional[Dict[str, Any]] = None,
        sum_value: Optional[float] = None,
    ) -> None:
        """One native Prometheus histogram family from log2 bucket
        counts (ops.histogram layout: bucket 0 holds {0}, bucket b holds
        [2^(b-1), 2^b-1]).

        Renders the cumulative ``<name>_bucket{le="..."}`` series — one
        line per log2 bucket up to the last occupied one, bounds at the
        bucket upper edges, plus the mandatory ``le="+Inf"`` line — and
        the ``<name>_sum`` / ``<name>_count`` samples.  The true sum is
        not recoverable from bucket counts, so ``_sum`` defaults to the
        conservative upper-bound estimate ``sum(count * bucket_hi)``
        unless the caller tracked it (``sum_value``)."""
        from ringpop_tpu_torch.ops import histogram as hg

        counts = [int(c) for c in bucket_counts]
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = {
                "help": help_,
                "type": "histogram",
                "samples": [],
            }
            self._order.append(name)

        def label_str(extra: Optional[Dict[str, Any]] = None) -> str:
            merged = dict(labels or {})
            if extra:
                merged.update(extra)
            if not merged:
                return ""
            return "{%s}" % ",".join(
                '%s="%s"' % (k, _escape_label(v))
                for k, v in sorted(merged.items())
            )

        last = max((b for b, c in enumerate(counts) if c), default=0)
        cum = 0
        for b in range(last + 1):
            cum += counts[b]
            fam["samples"].append(
                "%s_bucket%s %d"
                % (name, label_str({"le": str(hg.bucket_hi(b))}), cum)
            )
        total = sum(counts)
        fam["samples"].append(
            "%s_bucket%s %d" % (name, label_str({"le": "+Inf"}), total)
        )
        if sum_value is None:
            sum_value = float(
                sum(c * hg.bucket_hi(b) for b, c in enumerate(counts))
            )
        fam["samples"].append(
            "%s_sum%s %s" % (name, label_str(), _fmt_value(sum_value))
        )
        fam["samples"].append(
            "%s_count%s %d" % (name, label_str(), total)
        )

    def render(self) -> str:
        lines: List[str] = []
        for name in self._order:
            fam = self._families[name]
            if fam["help"]:
                lines.append(
                    "# HELP %s %s" % (name, _escape_help(fam["help"]))
                )
            lines.append("# TYPE %s %s" % (name, fam["type"]))
            lines.extend(fam["samples"])
        return "\n".join(lines) + ("\n" if lines else "")


# -- recorded-run rendering ------------------------------------------------

_COUNTERISH = (
    "pings_sent",
    "pings_delivered",
    "ping_reqs",
    "full_syncs",
    "changes_applied",
    "suspects_marked",
    "faulties_marked",
    "refutes",
    "piggyback_drops",
    "full_sync_records",
    "ping_req_inconclusive",
    "join_merges",
    "parity_overflow",
    "suspects_published",
    "faulties_published",
    "refutes_published",
    "leaves_published",
    "rumors_retired",
    "dirty_rows",
)


def render_ringpop_metrics(ringpop: Any) -> str:
    """The ``/admin/metrics`` body for a live node: meters, membership,
    protocol histogram, ring and dissemination state."""
    w = PromWriter()
    labels = {"app": ringpop.app, "instance": ringpop.whoami()}

    import time as _time

    w.sample(
        "ringpop_uptime_seconds",
        (_time.time() - ringpop.start_time) if ringpop.start_time else 0.0,
        "Seconds since bootstrap completed",
        "gauge",
        labels,
    )
    w.sample(
        "ringpop_ready",
        1 if ringpop.is_ready else 0,
        "1 once bootstrap completed",
        "gauge",
        labels,
    )

    for plane, meter in (
        ("client", ringpop.client_rate),
        ("server", ringpop.server_rate),
        ("total", ringpop.total_rate),
    ):
        d = meter.to_dict()
        plane_labels = dict(labels, plane=plane)
        w.sample(
            "ringpop_requests_total",
            d["count"],
            "Requests seen per plane (index.js:158-160 meters)",
            "counter",
            plane_labels,
        )
        w.sample(
            "ringpop_request_rate_1m",
            d["m1"],
            "1-minute EWMA request rate",
            "gauge",
            plane_labels,
        )

    membership = ringpop.membership
    w.sample(
        "ringpop_members",
        len(membership.members),
        "Known members in the membership list",
        "gauge",
        labels,
    )
    status_counts: Dict[str, int] = {}
    for m in membership.members:
        status_counts[m.status] = status_counts.get(m.status, 0) + 1
    for status, count in sorted(status_counts.items()):
        w.sample(
            "ringpop_members_by_status",
            count,
            "Known members by SWIM status",
            "gauge",
            dict(labels, status=status),
        )
    if membership.checksum is not None:
        w.sample(
            "ringpop_membership_checksum",
            membership.checksum,
            "FarmHash32 membership checksum (membership/index.js:48-75)",
            "gauge",
            labels,
        )

    w.sample(
        "ringpop_ring_servers",
        len(ringpop.ring.servers),
        "Servers currently on the consistent-hash ring",
        "gauge",
        labels,
    )
    if getattr(ringpop.ring, "checksum", None) is not None:
        w.sample(
            "ringpop_ring_checksum",
            ringpop.ring.checksum,
            "Checksum over sorted ring server names",
            "gauge",
            labels,
        )

    # protocol-period timing histogram (gossip/index.js:37,52-55)
    proto = ringpop.gossip.get_stats()
    timing = proto.get("protocolTiming") or {}
    for q in ("p50", "p95", "p99"):
        w.sample(
            "ringpop_protocol_period_ms",
            timing.get(q),
            "Protocol period duration percentiles",
            "gauge",
            dict(labels, quantile=q),
        )
    w.sample(
        "ringpop_protocol_periods_total",
        proto.get("protocolPeriods"),
        "Protocol periods completed",
        "counter",
        labels,
    )
    w.sample(
        "ringpop_changes_disseminated_total",
        proto.get("numChangesDisseminated"),
        "Membership changes disseminated on gossip bodies",
        "counter",
        labels,
    )

    # dissemination pressure
    dissemination = getattr(ringpop, "dissemination", None)
    if dissemination is not None:
        w.sample(
            "ringpop_dissemination_changes",
            len(getattr(dissemination, "changes", {}) or {}),
            "Changes pending dissemination",
            "gauge",
            labels,
        )
    return w.render()


# -- recorded-run rendering ------------------------------------------------

_COUNTERISH = (
    "pings_sent",
    "pings_delivered",
    "ping_reqs",
    "full_syncs",
    "changes_applied",
    "suspects_marked",
    "faulties_marked",
    "refutes",
    "piggyback_drops",
    "full_sync_records",
    "ping_req_inconclusive",
    "join_merges",
    "parity_overflow",
    "suspects_published",
    "faulties_published",
    "refutes_published",
    "leaves_published",
    "rumors_retired",
    "dirty_rows",
)


def render_device_histograms(
    hist: Any,
    tracks: Any,
    prefix: str = "ringpop_sim_",
    labels: Optional[Dict[str, Any]] = None,
) -> str:
    """Prometheus text for a drained device histogram bank: one native
    histogram family per track (``<prefix><track>``), rendered from the
    [len(tracks), NBUCKETS] log2 bucket counts the engines carry
    (obs.histograms drain layout)."""
    from ringpop_tpu_torch.obs.histograms import host_counts

    arr = host_counts(hist)
    w = PromWriter()
    for i, track in enumerate(tracks):
        w.histogram(
            prefix + str(track),
            arr[i],
            "Device-side log2 histogram track %s" % track,
            labels,
        )
    return w.render()


def render_slo_plane(
    plane: Any,
    tick: int = 0,
    prefix: str = "ringpop_slo_",
    labels: Optional[Dict[str, Any]] = None,
) -> str:
    """Prometheus text for one obs.slo.SLOWindowPlane: the pooled
    sliding-window bucket counts as a native histogram plus the window
    row's health gauges (success rate, burn rate, breach flag) and
    volume counters, all labeled by SLO target name."""
    w = PromWriter()
    row = plane.window_row(tick)
    slo_labels = dict(labels or {}, target=row["target"])
    w.histogram(
        prefix + "window",
        plane.window_counts(),
        "Pooled sliding-window observations feeding the SLO verdict",
        slo_labels,
    )
    w.sample(
        prefix + "window_queries",
        row["queries"],
        "Requests in the sliding window",
        "gauge",
        slo_labels,
    )
    w.sample(
        prefix + "window_errors",
        row["errors"],
        "Failed requests in the sliding window",
        "gauge",
        slo_labels,
    )
    w.sample(
        prefix + "success_rate",
        row["success_rate"],
        "Windowed success rate",
        "gauge",
        slo_labels,
    )
    w.sample(
        prefix + "burn_rate",
        row["burn_rate"],
        "Error-budget burn rate (1.0 = sustainable)",
        "gauge",
        slo_labels,
    )
    w.sample(
        prefix + "breach",
        1 if row["breach"] else 0,
        "1 while the sliding window violates the SLO",
        "gauge",
        slo_labels,
    )
    return w.render()


def render_tick_series(
    metrics: Any,
    prefix: str = "ringpop_sim_",
    labels: Optional[Dict[str, Any]] = None,
) -> str:
    """Prometheus text for a stacked metrics series (or one tick):
    counter fields render as window totals (``<prefix><field>_total``),
    everything else as last-value gauges."""
    import numpy as np

    if hasattr(metrics, "_asdict"):
        metrics = metrics._asdict()
    w = PromWriter()
    for field, arr in metrics.items():
        a = np.asarray(arr)
        if a.dtype == object:
            continue
        if field in _COUNTERISH:
            w.sample(
                prefix + field + "_total",
                int(a.sum()),
                "Window total of per-tick %s" % field,
                "counter",
                labels,
            )
        else:
            last = a.reshape(-1)[-1] if a.ndim else a
            w.sample(
                prefix + field,
                float(last) if a.dtype.kind == "f" else int(last),
                "Last-tick value of %s" % field,
                "gauge",
                labels,
            )
    return w.render()
