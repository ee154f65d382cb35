"""Profiler trace capture harness over ``torch.profiler``.

A copy of ``ringpop_tpu/obs/xprof.py``: the shared warm-then-measure loop
(:func:`ringpop_tpu_torch.obs.perf.timed_window`) runs inside a profiler
span, the captured Chrome-format trace is digested into a per-op
time-attribution table — top-K ops by summed duration, fuzzily keyed to a
named entry where an op name carries one — and the artifact is stamped as
an ``xprof.capture`` run-log row (schema-gated by
scripts/check_metrics_schema.py).  Failures are rows, never exceptions.

Where torch forces a difference from the JAX module:

- :func:`capture` profiles under ``torch.profiler.profile`` (CPU
  activity, plus CUDA when a card is present) and writes
  ``<trace_dir>/<phase>.trace.json`` with ``export_chrome_trace``;
  :func:`find_trace_files` takes that plain form as well as the
  ``*.trace.json.gz`` files ``jax.profiler`` writes.
- What the table digests: with a card, only the device records (``cat``
  ``kernel``, ``gpu_memcpy``, ``gpu_memset``) — the counterpart of the JAX
  module's per-HLO-op device table; on the CPU the ``cpu_op`` records
  (they nest, so a parent's duration includes its children's).  The
  ``digest`` field names which.  ``torch.profiler`` drops kernel records:
  the row carries ``kernel_records``, the kernel records it saw, and a
  card capture that saw no device record digests its ``cpu_op`` records
  and says so in ``note`` — it never reports "no device time".
- ``budget_entry`` keys: the port has no cost budget of its own, so the
  default entries are its kernels' names (``ops.toolkit.TWIN_REGISTRY``'s
  ``kernel_entry``): ``apply_updates_kernel`` keys to ``apply_updates``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

XPROF_EVENT = "xprof.capture"
# required xprof.capture row fields (the schema gate's field set)
XPROF_FIELDS = (
    "phase",
    "ok",
    "wall_s",
    "trace_dir",
    "num_trace_files",
    "total_self_us",
    "ops",
)
DEFAULT_TOP_K = 10
# the trace categories of work on the card (torch.profiler's CUDA activity)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def find_trace_files(trace_dir: str) -> List[str]:
    """Chrome-format trace files under ``trace_dir`` (``*.trace.json``
    from ``torch.profiler``, ``*.trace.json.gz`` from ``jax.profiler``),
    newest first."""
    paths = []
    for pattern in ("*.trace.json.gz", "*.trace.json"):
        paths += glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)
    return sorted(paths, key=lambda p: os.path.getmtime(p), reverse=True)


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """The ``traceEvents`` list of one (gzipped or plain) Chrome trace."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        doc = json.load(f)
    if isinstance(doc, list):  # bare event-array form
        return doc
    return list(doc.get("traceEvents", []))


def op_table(
    events: Sequence[Dict[str, Any]],
    top_k: int = DEFAULT_TOP_K,
    budget_entries: Optional[Sequence[str]] = None,
) -> Tuple[List[Dict[str, Any]], float]:
    """Aggregate complete ("X"-phase) events by name into the top-K
    self-time table: ``[{"name", "self_us", "count", "budget_entry"},
    ...]`` plus the total attributed microseconds.  Metadata events and
    zero-duration markers drop out."""
    agg: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        dur = ev.get("dur")
        name = ev.get("name")
        if not name or not isinstance(dur, (int, float)) or dur <= 0:
            continue
        row = agg.setdefault(str(name), [0.0, 0])
        row[0] += float(dur)
        row[1] += 1
    total = sum(v[0] for v in agg.values())
    ranked = sorted(agg.items(), key=lambda kv: kv[1][0], reverse=True)
    out = []
    for name, (self_us, count) in ranked[: max(0, int(top_k))]:
        out.append(
            {
                "name": name,
                "self_us": round(self_us, 3),
                "count": int(count),
                "budget_entry": match_budget_entry(name, budget_entries),
            }
        )
    return out, round(total, 3)


def match_budget_entry(
    op_name: str, entries: Optional[Sequence[str]]
) -> Optional[str]:
    """Fuzzy op-name -> entry-name key: the entry whose token set
    overlaps the op name most (``apply_updates_kernel(ApplyArgs, ...)``
    keys to ``apply_updates``).  None when nothing overlaps — most ops
    are the plain PyTorch ops between the kernels."""
    if not entries:
        return None
    op_tokens = set(_TOKEN_RE.findall(op_name.lower()))
    if not op_tokens:
        return None
    best, best_score = None, 0
    for entry in entries:
        tokens = set(_TOKEN_RE.findall(entry.lower()))
        score = len(op_tokens & tokens)
        if score > best_score:
            best, best_score = entry, score
    return best


def _budget_entry_names() -> List[str]:
    """The port's kernel names, the default ``budget_entry`` keys."""
    from ringpop_tpu_torch.ops import toolkit

    return sorted(t.kernel_entry for t in toolkit.TWIN_REGISTRY)


def _digest(events: Sequence[Dict[str, Any]], card: bool, row: Dict[str, Any]):
    """The events the table sums, with ``kernel_records`` / ``digest`` /
    ``note`` filled in on ``row``."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    row["kernel_records"] = sum(1 for e in device if e.get("cat") == "kernel")
    if card and device:
        row["digest"] = "device"
        return device
    row["digest"] = "cpu_op"
    if card:
        row["note"] = ("torch.profiler delivered no device record; "
                       "the table digests the cpu_op records")
    return [e for e in events if e.get("cat") == "cpu_op"]


def capture(
    run: Callable[[], Any],
    trace_dir: str,
    *,
    phase: str = "xprof",
    warmup: int = 1,
    repeats: int = 1,
    top_k: int = DEFAULT_TOP_K,
    recorder=None,
    statsd=None,
    **extra: Any,
) -> Dict[str, Any]:
    """Profile ``repeats`` fenced calls of ``run`` (after ``warmup``
    unprofiled calls) under ``torch.profiler.profile``, write the trace
    to ``<trace_dir>/<phase>.trace.json``, digest every trace file under
    ``trace_dir`` into the top-K op table, and stamp one
    ``xprof.capture`` row on ``recorder`` / ``xprof.*`` statsd keys,
    ops keyed to the port's kernel names.  Returns the
    row dict (``ok=False`` + ``error`` on any capture or parse failure;
    the measurement itself always completes)."""
    import torch

    from ringpop_tpu_torch.obs import perf

    os.makedirs(trace_dir, exist_ok=True)
    row: Dict[str, Any] = {
        "phase": phase,
        "ok": False,
        "wall_s": None,
        "trace_dir": trace_dir,
        "num_trace_files": 0,
        "total_self_us": 0.0,
        "ops": [],
        "kernel_records": 0,
    }
    row.update(extra)
    # warm outside the profiled span: the trace should attribute
    # steady-state execution, not first-call set-up
    for _ in range(max(0, warmup)):
        perf.fence(run())
    card = torch.cuda.is_available()
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            _, wall = perf.timed_window(run, warmup=0, repeats=repeats)
        row["wall_s"] = wall
        prof.export_chrome_trace(os.path.join(trace_dir, "%s.trace.json" % phase))
    except Exception as e:
        row["error"] = "profiler capture failed: %s" % (str(e)[:300],)
        _emit(row, recorder, statsd)
        return row
    try:
        files = find_trace_files(trace_dir)
        row["num_trace_files"] = len(files)
        if not files:
            row["error"] = "no trace files captured under %s" % trace_dir
            _emit(row, recorder, statsd)
            return row
        events: List[Dict[str, Any]] = []
        for p in files:
            events.extend(load_trace_events(p))
        ops, total = op_table(_digest(events, card, row), top_k=top_k,
                              budget_entries=_budget_entry_names())
        row["ops"] = ops
        row["total_self_us"] = total
        row["ok"] = True
    except Exception as e:
        row["error"] = "trace parse failed: %s" % (str(e)[:300],)
    _emit(row, recorder, statsd)
    return row


def _emit(row: Dict[str, Any], recorder, statsd) -> None:
    if recorder is not None:
        recorder.record_event(XPROF_EVENT, **row)
    if statsd is not None:
        from ringpop_tpu_torch.obs.statsd_bridge import XPROF_KEY_MAP

        if row.get("wall_s") is not None:
            _, key = XPROF_KEY_MAP["wall_s"]
            statsd.timing(key, float(row["wall_s"]) * 1e3)
        _, key = XPROF_KEY_MAP["ops"]
        statsd.gauge(key, len(row.get("ops") or []))


def render_table(row: Dict[str, Any]) -> str:
    """Console rendering of one capture row — the bench's human view."""
    lines = [
        "xprof[%s]: ok=%s files=%d total_self=%.1fus"
        % (
            row.get("phase"),
            row.get("ok"),
            row.get("num_trace_files", 0),
            row.get("total_self_us") or 0.0,
        )
    ]
    if row.get("note"):
        lines.append("  note: %s" % row["note"])
    if row.get("error"):
        lines.append("  error: %s" % row["error"])
    for op in row.get("ops") or []:
        lines.append(
            "  %10.1fus x%-5d %s%s"
            % (
                op["self_us"],
                op["count"],
                op["name"][:80],
                (
                    "  [%s]" % op["budget_entry"]
                    if op.get("budget_entry")
                    else ""
                ),
            )
        )
    return "\n".join(lines)


__all__: List[str] = [
    "DEFAULT_TOP_K",
    "DEVICE_CATS",
    "XPROF_EVENT",
    "XPROF_FIELDS",
    "capture",
    "find_trace_files",
    "load_trace_events",
    "match_budget_entry",
    "op_table",
    "render_table",
]
