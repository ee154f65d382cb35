"""RunRecorder — append-only JSONL run logs for simulation/bench runs.

A copy of ``ringpop_tpu/obs/recorder.py`` with the same run-log schema
(``SCHEMA_VERSION`` 1), so the JAX package's ``validate_run_log`` accepts
a log the port wrote; only :func:`backend_provenance` differs (it reports
torch, CUDA and the card instead of JAX's backend).

Every epidemic run, parity replay and bench invocation gets a durable,
queryable telemetry trail: the scanned engines return per-tick metric
time-series ([T]-shaped ``TickMetrics``/``ScalableMetrics``); the
recorder folds them into the existing ``Meter``/``Histogram`` primitives
(utils/stats.py) and streams JSONL rows to disk as they arrive — an
append-only log, one JSON object per line, so a crashed run still leaves
its prefix readable.

Row kinds (``kind`` field):

- ``header``  — schema version, run id, config, backend provenance.
  Always the first row.
- ``tick``    — one engine tick's metrics (possibly strided; the last
  tick of every recorded batch is always kept so convergence is visible).
- ``phase``   — a named wall-clock phase (compile, warm, measure, ...).
- ``event``   — free-form annotations (replays, faults injected, ...).
- ``summary`` — totals, convergence tick, histogram digests.  Always the
  last row of a finished log.

The schema is validated by :func:`validate_run_log` (also exposed via
``scripts/check_metrics_schema.py`` and the tier-1 test
``tests/obs/test_runlog_schema.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, IO, List, Optional

from itertools import count as _count

from ringpop_tpu_torch.utils.stats import Histogram, Meter

SCHEMA_VERSION = 1

# per-process sequence: two recorders born in the same wall-clock second
# (e.g. bench retry loops) must not share a default run_id — the second
# would append a mid-file header to the first's log
_RUN_SEQ = _count()

# kind -> required fields (beyond "kind")
_REQUIRED: Dict[str, tuple] = {
    "header": ("schema", "run_id", "config", "provenance"),
    "tick": ("tick", "metrics"),
    "phase": ("name", "wall_s"),
    "event": ("name",),
    "summary": ("ticks_recorded", "totals"),
}


def _jsonable(v: Any) -> Any:
    """numpy scalars and arrays -> plain python for json.dumps."""
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def iter_tick_rows(metrics: Any):
    """Yield per-tick row dicts from a metrics pytree — a NamedTuple or
    dict whose leaves are scalars (one row), [T]-arrays, or [T, B]-arrays
    (vmapped drivers; rows then hold [B]-vectors).  The ONE unstacking
    loop shared by the recorder, the statsd bridge and the sim trace tap.

    Every leaf must agree on the leading (time) dimension: a ragged
    pytree — some leaves scalar, some [T], or [T]s of different T —
    would silently mis-slice (leaf ``v[t]`` reads a different tick's
    value, or IndexErrors mid-stream), so it raises up front instead."""
    import numpy as np

    if hasattr(metrics, "_asdict"):
        metrics = metrics._asdict()
    arrs = {k: np.asarray(v) for k, v in metrics.items()}
    if not arrs:
        return
    lead_dims = {k: (v.shape[0] if v.ndim else None) for k, v in arrs.items()}
    distinct = set(lead_dims.values())
    if len(distinct) > 1:
        raise ValueError(
            "ragged metrics pytree: leaves disagree on the leading "
            "(time) dimension — %s"
            % ", ".join(
                "%s: %s" % (k, "scalar" if d is None else "[%d]" % d)
                for k, d in sorted(lead_dims.items())
            )
        )
    lead = next(iter(arrs.values()))
    if lead.ndim == 0:
        yield arrs
        return
    for t in range(lead.shape[0]):
        yield {k: v[t] for k, v in arrs.items()}


def backend_provenance() -> Dict[str, Any]:
    """Best-effort backend/platform provenance, under the JAX recorder's
    keys where they exist (``pid``, ``platform``, ``device_count``) plus
    the torch build's (``torch_version``, ``cuda_version``) and the card's
    name.  Never raises and never creates a CUDA context: the device
    fields are read only when one already exists."""
    prov: Dict[str, Any] = {"pid": os.getpid()}
    try:
        import torch

        prov["torch_version"] = torch.__version__
        prov["cuda_version"] = torch.version.cuda
        if torch.cuda.is_initialized():
            prov["platform"] = "gpu"
            prov["device_count"] = torch.cuda.device_count()
            prov["device_name"] = torch.cuda.get_device_name(torch.cuda.current_device())
        else:
            prov["platform"] = "cpu"
    except Exception:  # pragma: no cover — provenance is best-effort
        pass
    return prov


class RunRecorder:
    """Folds per-tick metric series into Meters/Histograms and writes an
    append-only JSONL run log.

    ``path`` may be a file path (used as-is) or a directory (the log
    becomes ``<dir>/<run_id>.runlog.jsonl``).  ``stride`` keeps every
    k-th tick row (plus the last row of each recorded batch); totals and
    histograms always fold EVERY tick regardless of stride.
    """

    def __init__(
        self,
        path: str,
        run_id: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        stride: int = 1,
        clock=time.time,
    ):
        if stride < 1:
            raise ValueError("stride must be >= 1")
        self._clock = clock
        self.run_id = run_id or "run-%d-%d-%d" % (
            int(clock()),
            os.getpid(),
            next(_RUN_SEQ),
        )
        if os.path.isdir(path) or path.endswith(os.sep):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "%s.runlog.jsonl" % self.run_id)
        self.path = path
        self.stride = stride
        self.config = dict(config or {})
        self.meters: Dict[str, Meter] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.totals: Dict[str, float] = {}
        self.ticks_recorded = 0
        self.convergence_tick: Optional[int] = None
        self._next_tick = 0
        self._finished = False
        self._header_written = False
        self._fh: Optional[IO[str]] = open(path, "a", encoding="utf-8")

    # -- low-level --------------------------------------------------------

    def _ensure_header(self) -> None:
        # header deferred to the first row so config enrichment by the
        # driver (SimCluster.attach_recorder et al.) lands in it
        if self._header_written or self._fh is None:
            return
        self._header_written = True
        self._fh.write(
            json.dumps(
                {
                    "kind": "header",
                    "schema": SCHEMA_VERSION,
                    "run_id": self.run_id,
                    "created_unix": self._clock(),
                    "config": _jsonable(self.config),
                    "provenance": backend_provenance(),
                },
                sort_keys=True,
            )
            + "\n"
        )

    def _write(self, row: Dict[str, Any]) -> None:
        if self._fh is None:
            raise RuntimeError("recorder already closed")
        self._ensure_header()
        self._fh.write(json.dumps(row, sort_keys=True) + "\n")
        self._fh.flush()

    def describe(self, engine: str, n: int, params: Any, **extra: Any) -> None:
        """The ONE header-enrichment contract shared by every driver's
        attach_recorder (and bench.py): stamp the engine name, cluster
        size and static params into the header config.  setdefault
        semantics — the first describer wins, so a multi-window log
        keeps its original identity."""
        self.config.setdefault("engine", engine)
        self.config.setdefault("n", n)
        if hasattr(params, "_asdict"):
            params = params._asdict()
        self.config.setdefault("params", params)
        for k, v in extra.items():
            self.config.setdefault(k, v)

    # -- metrics ingestion ------------------------------------------------

    def _fold(self, field: str, value: float) -> None:
        self.totals[field] = self.totals.get(field, 0) + value
        hist = self.histograms.get(field)
        if hist is None:
            hist = self.histograms[field] = Histogram()
        hist.update(value)
        meter = self.meters.get(field)
        if meter is None:
            meter = self.meters[field] = Meter(now=self._clock)
        meter.mark(int(value) if float(value).is_integer() else 1)

    def record_tick(self, row: Dict[str, Any], tick: Optional[int] = None) -> int:
        """One tick's metrics (a plain dict of scalars).  Returns the
        tick index assigned.  Every tick folds into totals/histograms;
        only stride-selected ticks (and batch tails, via record_ticks)
        get their own JSONL row."""
        return self._record_tick(row, tick, force_row=True)

    def _record_tick(
        self, row: Dict[str, Any], tick: Optional[int], force_row: bool
    ) -> int:
        if tick is None:
            tick = self._next_tick
        self._next_tick = tick + 1
        clean = {k: _jsonable(v) for k, v in row.items()}
        for k, v in clean.items():
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                self._fold(k, v)
        conv = clean.get("converged")
        if isinstance(conv, list):
            # vmapped [B]-row: converged means EVERY cluster converged
            # (an empty or any-False list must not read as truthy)
            conv = bool(conv) and all(conv)
        if (
            self.convergence_tick is None
            and isinstance(conv, (bool, int))
            and conv
        ):
            self.convergence_tick = tick
        self.ticks_recorded += 1
        if force_row or tick % self.stride == 0:
            self._write({"kind": "tick", "tick": tick, "metrics": clean})
        return tick

    def record_ticks(self, metrics: Any, start_tick: Optional[int] = None) -> int:
        """A stacked metrics series — a NamedTuple (or dict) of
        [T]-shaped arrays, exactly what the ``lax.scan`` drivers return
        ([T, B] under the vmapped driver: per-cluster vectors are kept
        in the row as lists; only scalars fold into totals).  Folds
        every tick; writes stride-selected rows plus the batch's last
        row.  Returns the number of ticks ingested."""
        rows = list(iter_tick_rows(metrics))
        tick0 = self._next_tick if start_tick is None else start_tick
        for t, row in enumerate(rows):
            self._record_tick(
                row, tick0 + t, force_row=(t == len(rows) - 1)
            )
        return len(rows)

    # -- phases / events --------------------------------------------------

    def phase(self, name: str) -> "_PhaseTimer":
        """Context manager timing one named wall-clock phase."""
        return _PhaseTimer(self, name)

    def record_phase(self, name: str, wall_s: float, **extra: Any) -> None:
        row = {"kind": "phase", "name": name, "wall_s": wall_s}
        row.update(_jsonable(extra))
        self._write(row)

    def record_event(self, name: str, **extra: Any) -> None:
        row = {"kind": "event", "name": name}
        row.update(_jsonable(extra))
        self._write(row)

    def record_trace_sidecar(
        self, trace: Dict[str, Any], name: str = "flight"
    ) -> str:
        """Write a Chrome-trace JSON sidecar next to this run log and
        link it with a ``trace_sidecar`` event row (relative path, so
        the pair stays valid when the runlog directory moves).  The
        sidecar is schema-validated before writing (obs.chrome_trace);
        the CI gate (scripts/check_metrics_schema.py) re-validates both
        the link and the file."""
        from ringpop_tpu_torch.obs.chrome_trace import write_chrome_trace

        base = self.path
        suffix = ".runlog.jsonl"
        if base.endswith(suffix):
            base = base[: -len(suffix)]
        sidecar = "%s.%s.trace.json" % (base, name)
        write_chrome_trace(trace, sidecar)
        self.record_event(
            "trace_sidecar",
            sidecar=name,
            path=os.path.basename(sidecar),
        )
        return sidecar

    # -- teardown ---------------------------------------------------------

    def finish(self, **extra: Any) -> Dict[str, Any]:
        """Write the summary row and close the log.  Idempotent, and a
        no-op on an already-closed recorder (a log sealed early — e.g.
        before a re-exec — stays header-valid without a summary)."""
        if self._finished or self._fh is None:
            return {}
        summary = {
            "kind": "summary",
            "ticks_recorded": self.ticks_recorded,
            "convergence_tick": self.convergence_tick,
            "totals": _jsonable(self.totals),
            "histograms": {
                k: _jsonable(h.to_dict()) for k, h in self.histograms.items()
            },
        }
        summary.update(_jsonable(extra))
        self._write(summary)
        self._finished = True
        self.close()
        return summary

    def close(self) -> None:
        if self._fh is not None:
            self._ensure_header()  # even an aborted run has a valid log
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "RunRecorder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.finish()
        else:
            self.close()


class _PhaseTimer:
    def __init__(self, recorder: RunRecorder, name: str):
        self.recorder = recorder
        self.name = name

    def __enter__(self) -> "_PhaseTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.recorder.record_phase(
            self.name,
            time.perf_counter() - self._t0,
            **({"error": repr(exc)} if exc is not None else {}),
        )


# -- reading + schema validation ------------------------------------------


def read_run_log(path: str) -> Dict[str, Any]:
    """Round-trip reader: {header, ticks, phases, events, summary}."""
    out: Dict[str, Any] = {
        "header": None,
        "ticks": [],
        "phases": [],
        "events": [],
        "summary": None,
    }
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            kind = row.get("kind")
            if kind == "header":
                out["header"] = row
            elif kind == "tick":
                out["ticks"].append(row)
            elif kind == "phase":
                out["phases"].append(row)
            elif kind == "event":
                out["events"].append(row)
            elif kind == "summary":
                out["summary"] = row
    return out


def validate_run_log(path: str) -> List[str]:
    """Schema check; returns a list of human-readable problems (empty ==
    valid).  A missing summary row is allowed (crashed/in-flight runs
    keep their readable prefix), a missing or late header is not."""
    problems: List[str] = []
    saw_header = False
    last_tick = None
    with open(path, encoding="utf-8") as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as e:
                problems.append("%s:%d: not JSON (%s)" % (path, ln, e))
                continue
            if not isinstance(row, dict):
                problems.append("%s:%d: row is not an object" % (path, ln))
                continue
            kind = row.get("kind")
            if kind not in _REQUIRED:
                problems.append(
                    "%s:%d: unknown kind %r" % (path, ln, kind)
                )
                continue
            if ln == 1 and kind != "header":
                problems.append(
                    "%s:1: first row must be the header, got %r"
                    % (path, kind)
                )
            for field in _REQUIRED[kind]:
                if field not in row:
                    problems.append(
                        "%s:%d: %s row missing %r" % (path, ln, kind, field)
                    )
            if kind == "header":
                saw_header = True
                if row.get("schema") != SCHEMA_VERSION:
                    problems.append(
                        "%s:%d: schema %r != %d"
                        % (path, ln, row.get("schema"), SCHEMA_VERSION)
                    )
            elif kind == "tick":
                t = row.get("tick")
                if not isinstance(t, int):
                    problems.append(
                        "%s:%d: tick index must be int" % (path, ln)
                    )
                elif last_tick is not None and t <= last_tick:
                    problems.append(
                        "%s:%d: tick %d not increasing (prev %d)"
                        % (path, ln, t, last_tick)
                    )
                else:
                    last_tick = t
                if not isinstance(row.get("metrics"), dict):
                    problems.append(
                        "%s:%d: tick metrics must be an object" % (path, ln)
                    )
    if not saw_header:
        problems.append("%s: no header row" % path)
    return problems
