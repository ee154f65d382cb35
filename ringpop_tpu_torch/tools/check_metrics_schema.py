"""Validate JSONL run logs and their trace sidecars: the counterpart of the
JAX package's ``scripts/check_metrics_schema.py``, over the port's
``obs/recorder.validate_run_log`` and ``obs/chrome_trace.
validate_chrome_trace``.

Every ``*.runlog.jsonl`` given (default: every one under ``runs_torch/``)
must parse against the recorder's schema (one JSON object a line, a
leading header row with the current schema version, increasing tick
indices); its route tick rows must carry the whole ``RouteMetrics``
counter set, its event rows (route windows, checkpoints, mesh windows and
exchange drains, ``perf.phase``, ``hist.drain``, ``reqtrace.drain``,
``slo.window``/``slo.breach``, ``xprof.capture``) their fields, and every
``trace_sidecar`` row must point at a file beside the log.  Every
``*.trace.json`` sidecar must parse against the Trace Event Format schema.
The field sets are the JAX checker's, so both packages' logs are checked.

Usage: python -m ringpop_tpu_torch.tools.check_metrics_schema [paths...]

Nothing here touches a tensor, so the tool takes no ``--device`` and
needs no card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional

from ringpop_tpu_torch.obs.chrome_trace import validate_chrome_trace
from ringpop_tpu_torch.obs.recorder import validate_run_log
from ringpop_tpu_torch.tools import REPO_ROOT, RUNS_DIR

# A tick row that carries any route_* field must carry the whole
# RouteMetrics counter set: a partial row means the recorder and the
# engine's RouteMetrics drifted (tests/test_torch_tools.py holds this set
# against models/route/plane.RouteMetrics._fields).
ROUTE_TICK_FIELDS = frozenset(
    {
        "route_queries",
        "route_misroutes",
        "route_reroute_local",
        "route_reroute_remote",
        "route_keys_diverged",
        "route_checksums_differ",
        "route_checksum_rejects",
        "route_ring_changed",
        "route_ring_dirty_buckets",
        "route_ring_full_rebuilds",
        "route_ring_points",
    }
)
# event rows announcing a measured routing window must identify the ring
# implementation and the workload shape
ROUTE_EVENT_FIELDS = {
    "route_window": ("ring_impl", "n", "q"),
    "route_rebuild_ab": ("n", "incremental_ms", "full_sort_ms"),
    # recovery-plane lifecycle rows (models/sim/recovery.py):
    # every save/corrupt/resume must be attributable to a tick + artifact
    "ckpt.saved": ("tick", "path", "nbytes", "shards", "wall_s"),
    "ckpt.corrupt": ("tick", "path", "error"),
    "ckpt.resumed": ("tick", "path", "skipped_corrupt"),
    "ckpt_window": ("n", "every", "overhead_frac", "save_mbps_single"),
    # mesh plane events: every weak-scaling rung names its
    # shard count + resolved exchange mode, the summary row carries the
    # efficiency AND the bitwise gate verdict, and the resolution note
    # is attributable to a requested mode + shard count
    "mesh_window": (
        "n",
        "shards",
        "ticks",
        "exchange_mode",
        "node_ticks_per_sec",
    ),
    "weak_scaling": (
        "n_per_shard",
        "shards",
        "node_ticks_per_sec",
        "efficiency",
        "bitwise_equal",
    ),
    "mesh_exchange_resolution": (
        "requested",
        "mode",
        "impl",
        "shards",
        "single_device_resolution",
        "differs_from_single_device",
    ),
    # performance observatory: every host phase-timing row
    # names its phase, wall and call count (obs/perf.py DispatchTimer /
    # timed_window), and every device-histogram drain names its source
    # plane and carries the per-track summaries (obs/histograms.py
    # drain_row — tracks is a dict of {count, p50, p95, p99, ...})
    "perf.phase": ("phase", "wall_s", "calls"),
    "hist.drain": ("source", "tracks"),
    # kernel toolkit: every backend-resolved fused-op knob is
    # an observable event row (ops.toolkit.resolution_note — the
    # single-device generalization of mesh_exchange_resolution)
    "op_resolution": (
        "knob",
        "requested",
        "impl",
        "backend",
        "single_device_resolution",
        "differs_from_single_device",
    ),
    # fused full-fidelity tick: every measured A/B window of
    # the full-engine ladder names its size, tick mode, and the bitwise
    # gate verdict
    "full_window": (
        "n",
        "ticks",
        "fused_tick",
        "node_ticks_per_sec",
        "bitwise_equal",
    ),
    # mesh observatory: every per-shard exchange drain row
    # carries the full ExchangeMetrics counter set plus the window's
    # identity — kept in lockstep with ops.exchange.ExchangeMetrics and
    # obs.exchange_stats.EXCHANGE_DRAIN_EXTRAS by
    # tests/obs/test_runlog_schema.py
    "mesh.exchange.drain": (
        "source",
        "shards",
        "w",
        "cap",
        "local_rows",
        "shard",
        "ticks",
        "a2a_pull",
        "a2a_push",
        "fallback_pull",
        "fallback_push",
        "pull_rows",
        "push_rows",
        "dest_shards_pull",
        "dest_shards_push",
        "wire_bytes_pull",
        "wire_bytes_push",
    ),
    # measured-vs-model reconciliation rows (obs.exchange_stats.reconcile
    # + a source tag): both byte totals must ship so a logged window is
    # auditable without rerunning the storm
    "traffic_reconcile": (
        "source",
        "shards",
        "n",
        "w",
        "cap",
        "ticks",
        "measured_interconnect",
        "model_interconnect",
        "ratio",
        "fallback_trips",
    ),
    # request observatory: every drained request-trace window
    # names its sampling configuration and carries the sampled-subset
    # counter object (obs.requests.drain_row — counts is a dict holding
    # every obs.requests.COUNT_FIELDS key, checked below); every SLO
    # window row carries the windowed health verdict, and every breach
    # names its violated clauses.  Field sets are kept in lockstep with
    # obs/requests.py and obs/slo.py by tests/obs/test_runlog_schema.py.
    "reqtrace.drain": (
        "source",
        "records",
        "drops",
        "cap",
        "sample_log2",
        "counts",
    ),
    "slo.window": (
        "target",
        "tick",
        "window_ticks",
        "windows",
        "queries",
        "errors",
        "success_rate",
        "burn_rate",
        "breach",
        "breach_reason",
    ),
    "slo.breach": (
        "target",
        "tick",
        "window_ticks",
        "reason",
        "burn_rate",
        "success_rate",
    ),
    # profiler capture rows (obs.xprof.XPROF_FIELDS — pinned by
    # tests/obs/test_runlog_schema.py): every capture names its phase
    # and trace artifact even when the capture itself failed (ok=False)
    "xprof.capture": (
        "phase",
        "ok",
        "wall_s",
        "trace_dir",
        "num_trace_files",
        "total_self_us",
        "ops",
    ),
}


# copies of the decoder's registries, held against obs.requests.COUNT_FIELDS
# and obs.slo.WINDOW_QS by tests/test_torch_tools.py
REQTRACE_COUNT_FIELDS = (
    "queries",
    "misroutes",
    "reroute_local",
    "reroute_remote",
    "keys_diverged",
    "checksums_differ",
    "checksum_rejects",
)
SLO_WINDOW_QS = (50, 95, 99)


def _check_reqtrace_drain(row: dict, path: str, ln: int) -> list:
    """reqtrace.drain rows: the counts object must carry every
    sampled-subset counter the decoder reconciles against."""
    problems = []
    counts = row.get("counts")
    if not isinstance(counts, dict):
        if "counts" in row:
            problems.append(
                "%s:%d: reqtrace.drain counts must be an object"
                % (path, ln)
            )
        return problems
    for field in REQTRACE_COUNT_FIELDS:
        if field not in counts:
            problems.append(
                "%s:%d: reqtrace.drain counts missing %r"
                % (path, ln, field)
            )
    return problems


def _check_slo_window(row: dict, path: str, ln: int) -> list:
    """slo.window rows: every windowed percentile key must be present
    (None for an empty window is valid)."""
    problems = []
    for q in SLO_WINDOW_QS:
        if "p%d" % q not in row:
            problems.append(
                "%s:%d: slo.window row missing %r" % (path, ln, "p%d" % q)
            )
    return problems


def _check_hist_drain(row: dict, path: str, ln: int) -> list:
    """hist.drain rows: per-track summaries must carry count + the
    p50/p95/p99 keys (None for empty tracks is valid)."""
    problems = []
    tracks = row.get("tracks")
    if not isinstance(tracks, dict):
        if "tracks" in row:
            problems.append(
                "%s:%d: hist.drain tracks must be an object" % (path, ln)
            )
        return problems
    for name, stats in tracks.items():
        if not isinstance(stats, dict):
            problems.append(
                "%s:%d: hist.drain track %r must be an object"
                % (path, ln, name)
            )
            continue
        for field in ("count", "p50", "p95", "p99"):
            if field not in stats:
                problems.append(
                    "%s:%d: hist.drain track %r missing %r"
                    % (path, ln, name, field)
                )
    return problems


def _check_route_rows(path: str) -> list:
    """Routing-plane runlog validation: complete route_* tick rows and
    well-formed route event rows."""
    problems = []
    with open(path, encoding="utf-8") as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue  # validate_run_log already reports this
            if not isinstance(row, dict):
                continue
            if row.get("kind") == "tick" and isinstance(
                row.get("metrics"), dict
            ):
                keys = set(row["metrics"])
                if any(k.startswith("route_") for k in keys):
                    missing = ROUTE_TICK_FIELDS - keys
                    if missing:
                        problems.append(
                            "%s:%d: route tick row missing %s"
                            % (path, ln, ", ".join(sorted(missing)))
                        )
            elif row.get("kind") == "event":
                need = ROUTE_EVENT_FIELDS.get(row.get("name"))
                if need:
                    for field in need:
                        if field not in row:
                            problems.append(
                                "%s:%d: %s event missing %r"
                                % (path, ln, row["name"], field)
                            )
                if row.get("name") == "hist.drain":
                    problems.extend(_check_hist_drain(row, path, ln))
                elif row.get("name") == "reqtrace.drain":
                    problems.extend(_check_reqtrace_drain(row, path, ln))
                elif row.get("name") == "slo.window":
                    problems.extend(_check_slo_window(row, path, ln))
    return problems


def find_run_logs(root: str = str(RUNS_DIR)) -> list:
    return sorted(
        glob.glob(os.path.join(root, "**", "*.runlog.jsonl"), recursive=True)
    )


def find_trace_sidecars(root: str = str(RUNS_DIR)) -> list:
    return sorted(
        glob.glob(os.path.join(root, "**", "*.trace.json"), recursive=True)
    )


def _check_sidecar_links(path: str) -> list:
    """Every trace_sidecar event row in a runlog must reference a file
    that exists next to the log (the pair ships together)."""
    problems = []
    logdir = os.path.dirname(os.path.abspath(path))
    with open(path, encoding="utf-8") as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue  # validate_run_log already reports this
            if (
                isinstance(row, dict)
                and row.get("kind") == "event"
                and row.get("name") == "trace_sidecar"
            ):
                ref = row.get("path")
                if not isinstance(ref, str):
                    problems.append(
                        "%s:%d: trace_sidecar row missing path" % (path, ln)
                    )
                elif not os.path.exists(os.path.join(logdir, ref)):
                    problems.append(
                        "%s:%d: trace_sidecar points at missing file %r"
                        % (path, ln, ref)
                    )
    return problems


def _shown(path: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), REPO_ROOT)
    return path if rel.startswith("..") else rel


def check(paths=None, verbose: bool = True) -> list:
    """Returns the list of problems across all logs and sidecars (empty
    == all valid)."""
    if paths:
        paths = list(paths)
    else:
        paths = find_run_logs() + find_trace_sidecars()
    problems = []
    for path in paths:
        if path.endswith(".trace.json"):
            try:
                with open(path, encoding="utf-8") as fh:
                    trace = json.load(fh)
            except ValueError as e:
                found = ["%s: not JSON (%s)" % (path, e)]
            else:
                found = ["%s: %s" % (path, p) for p in validate_chrome_trace(trace)]
        else:
            found = validate_run_log(path)
            found.extend(_check_sidecar_links(path))
            found.extend(_check_route_rows(path))
        problems.extend(found)
        if verbose:
            status = "OK" if not found else "%d problem(s)" % len(found)
            print("%s: %s" % (_shown(path), status))
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="check-metrics-schema", description=__doc__.splitlines()[0])
    p.add_argument("paths", nargs="*", help="run logs and sidecars (default: runs_torch/)")
    args = p.parse_args(argv)
    paths = args.paths or None
    if paths is None and not (find_run_logs() or find_trace_sidecars()):
        print("no *.runlog.jsonl or *.trace.json files found under %s" % RUNS_DIR)
        return 0
    problems = check(paths)
    for prob in problems:
        print(prob, file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
