"""The ``traffic`` prong: the mesh's measured exchange bytes against the
traffic model, and both against ``budgets/TRAFFIC_BUDGET.json``.

Counterpart of the JAX package's ``scripts/check_traffic_model.py``.  It
runs the port's ``ShardedStorm`` at the JAX script's mesh entries (n=64,
``u=128``, 8 quiet ticks on 2, 4 and 8 shards of one device) with the
exchange telemetry plane on, drains the per-shard wire counters and
reconciles the measured interconnect bytes with the analytic model
(``obs.exchange_stats.reconcile``: exact whenever every trip took the
all-to-all at the default cap).  Two checks an entry, both rule
``traffic-budget`` (JAX's rule id):

1. measured against model within ``rtol``;
2. both against the committed manifest: a silent change to the wire
   format, the cap sizing or the byte pricing fails the diff.

An entry that fails to run is ``traffic-failure``; ``--write`` refuses a
manifest with one.  The counters are the same on every device, so the
manifest holds the JAX package's numbers and the card's run is diffed
against it as the CPU's is.  The mesh runs on the device the caller names:
the CLI passes the card unless ``--device cpu``.

    python -m ringpop_tpu_torch.analysis --prong traffic                 # diff, on the card
    python -m ringpop_tpu_torch.analysis --prong traffic --device cpu    # diff, on the CPU
    python -m ringpop_tpu_torch.analysis --prong traffic --write         # regenerate
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional

from ringpop_tpu_torch.analysis import manifests
from ringpop_tpu_torch.analysis.findings import Finding

PRONG = "traffic"
MANIFEST_NAME = "TRAFFIC_BUDGET.json"
WRITE_HINT = "python -m ringpop_tpu_torch.analysis --prong traffic --write"
DEFAULT_RTOL = 0.01

# the JAX script's small configs; the counters are deterministic (seed 0)
MESH_CONFIGS = (
    {"shards": 2, "n": 64, "u": 128, "ticks": 8},
    {"shards": 4, "n": 64, "u": 128, "ticks": 8},
    {"shards": 8, "n": 64, "u": 128, "ticks": 8},
)

# config identity (exact: a mismatch is a stale manifest) and the
# rtol-banded measurements
EXACT_FIELDS = ("shards", "n", "w", "cap", "ticks", "fallback_trips")
BANDED_FIELDS = ("measured_interconnect", "model_interconnect")


def entry_name(cfg: Dict) -> str:
    return "mesh-s%d-n%d" % (cfg["shards"], cfg["n"])


def measure_entry(cfg: Dict, device) -> Dict[str, object]:
    """One config's reconciliation record: ``ticks`` quiet storm ticks on
    a ``shards``-shard mesh of ``device`` with the telemetry plane on,
    drained and reconciled.  A failure comes back as ``{"error": ...}``,
    so one broken config does not hide the rest."""
    try:
        from ringpop_tpu_torch.models.sim import engine_scalable as es
        from ringpop_tpu_torch.obs import exchange_stats as oxs
        from ringpop_tpu_torch.parallel import mesh as pmesh

        shards, n, u = cfg["shards"], cfg["n"], cfg["u"]
        params = es.ScalableParams(n=n, u=u, exchange_metrics=shards)
        storm = pmesh.ShardedStorm(n, mesh=pmesh.make_mesh(shards, device=device),
                                   params=params)
        if storm.exchange_mode != "shard_map":
            return {"error": "exchange mode %r (the gate measures the shard_map plane)"
                    % (storm.exchange_mode,)}
        for _ in range(cfg["ticks"]):
            storm.step()
        drained = storm.drain_exchange_metrics(reset=False)
        return oxs.reconcile(drained["totals"], n=n, w=u // 32)
    except Exception as e:  # one broken config must not hide the rest
        return {"error": "%s: %s" % (type(e).__name__, e)}


def collect_measurements(entry_names: Optional[Iterable[str]] = None, *,
                         device) -> Dict[str, Dict]:
    names = None if entry_names is None else set(entry_names)
    return {entry_name(cfg): measure_entry(cfg, device) for cfg in MESH_CONFIGS
            if names is None or entry_name(cfg) in names}


def load_manifest(path: Optional[Path] = None) -> Optional[Dict]:
    p = Path(path or manifests.manifest_path(MANIFEST_NAME))
    return manifests.load(MANIFEST_NAME, p) if p.exists() else None


def write_manifest(actual: Dict[str, Dict], path: Optional[Path] = None) -> Path:
    manifests.refuse_failed(actual)
    return manifests.write(MANIFEST_NAME, {"version": 1, "rtol": DEFAULT_RTOL,
                                           "entries": actual}, path)


def _finding(name: str, message: str, rule: str = "traffic-budget") -> Finding:
    return Finding(rule=rule, path="<entry:%s>" % name, line=0, message=message, prong=PRONG)


def reconcile_findings(actual: Dict[str, Dict], rtol: float = DEFAULT_RTOL) -> List[Finding]:
    """The model-against-measurement check, manifest-free."""
    out: List[Finding] = []
    for name, rec in sorted(actual.items()):
        if "error" in rec:
            out.append(_finding(name, "measurement failed: %s" % rec["error"],
                                "traffic-failure"))
            continue
        model, measured = int(rec["model_interconnect"]), int(rec["measured_interconnect"])
        if abs(measured - model) > rtol * max(model, 1):
            out.append(_finding(
                name,
                "measured interconnect %d vs model %d (ratio %s, %d fallback trips) "
                "exceeds rtol %g" % (measured, model, rec.get("ratio"),
                                     int(rec.get("fallback_trips", 0)), rtol)))
    return out


def compare_to_manifest(actual: Dict[str, Dict], manifest: Dict,
                        rtol: float = DEFAULT_RTOL) -> List[Finding]:
    out: List[Finding] = []
    entries = manifest.get("entries", {})
    for name in sorted(set(entries) - set(actual)):
        out.append(_finding(name, "manifest entry not measured (stale manifest?)"))
    for name, rec in sorted(actual.items()):
        if "error" in rec:
            continue  # already a reconcile finding
        exp = entries.get(name)
        if exp is None:
            out.append(_finding(name, "no manifest entry — run %s" % WRITE_HINT))
            continue
        for f in EXACT_FIELDS:
            if int(rec[f]) != int(exp[f]):
                out.append(_finding(name, "%s changed: measured %d, manifest %d"
                                    % (f, int(rec[f]), int(exp[f]))))
        for f in BANDED_FIELDS:
            a, e = int(rec[f]), int(exp[f])
            if abs(a - e) > rtol * max(e, 1):
                out.append(_finding(name, "%s drifted: measured %d, manifest %d (rtol %g)"
                                    % (f, a, e, rtol)))
    return out


def check_against_manifest(entry_names: Optional[Iterable[str]] = None,
                           path: Optional[Path] = None, rtol: float = DEFAULT_RTOL, *,
                           device) -> List[Finding]:
    manifest = load_manifest(path)
    if manifest is None:
        return [_finding("*", "missing manifest %s — run %s"
                         % (path or manifests.manifest_path(MANIFEST_NAME), WRITE_HINT))]
    actual = collect_measurements(entry_names, device=device)
    if entry_names is not None:
        keep = set(entry_names)
        manifest = dict(manifest, entries={k: v for k, v in manifest.get("entries", {}).items()
                                           if k in keep})
    return reconcile_findings(actual, rtol) + compare_to_manifest(actual, manifest, rtol)
