"""Prometheus text exposition (text format 0.0.4) of the simulation
drivers' device telemetry and recorded runs.

A copy of the device half of ``ringpop_tpu/obs/prometheus.py``: the
minimal purpose-built writer (:class:`PromWriter`, with native histogram
families over the log2 buckets of ``ops.histogram``),
:func:`render_device_histograms` (a drained ``[tracks, NBUCKETS]`` bank),
:func:`render_slo_plane` (an ``obs.slo.SLOWindowPlane``) and
:func:`render_tick_series` (a stacked metrics series).  The bucket banks
are read through ``obs.histograms.host_counts``, so the port's int32
tensors of uint32 bits render as the JAX package's uint32 arrays do.

Left out: the JAX module's ``render_ringpop_metrics``, the
``/admin/metrics`` body of a live node, which reads a live ``Ringpop``
facade (meters, membership, gossip stats).  That facade is host-only
code of the JAX package with no device half, and the port has none.
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
