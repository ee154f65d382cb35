"""The ``scale`` prong: static memory-feasibility ceilings against the
card's memory (``budgets/SCALE_BUDGET.json``).

Counterpart of ``ringpop_tpu/analysis/scale_budget.py``.  For every entry
of the graph prong's registry, :func:`.ranges.buffer_poly` prices the
recording as a polynomial in N (``{exponent: bytes}``, the exponent
counting scaled dims) and a binary search finds **N\\***: the largest N
at or under the entry's declared ceiling whose footprint fits the budget.
The manifest pins ``n_star`` (within :data:`DEFAULT_RTOL`, both
directions), ``degree`` (exactly: an O(N) plan growing an O(N^2) plane
may not move an N\\* that is already ceiling-bound), ``n_max``,
``ceiling_bound`` and ``poly_bytes``.

The budget is the H100's memory, not JAX's 12 GiB (a TPU's): the
``total_memory`` that ``torch.cuda.get_device_properties(0)`` reports on
the card, read there by ``chip_smoke.py``, which also holds the polynomial
against ``torch.cuda.max_memory_allocated`` over a real tick.  The
polynomial sums every new storage an entry makes with no liveness, so N\\*
is a floor on what fits.  Like JAX's, the analysis has no backend: the
gate always compares.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional

from ringpop_tpu_torch.analysis import manifests, ranges
from ringpop_tpu_torch.analysis.findings import Finding

PRONG = "scale"
MANIFEST_NAME = "SCALE_BUDGET.json"
DEFAULT_RTOL = 0.05
# torch.cuda.get_device_properties(0).total_memory of the card the port is
# measured on: NVIDIA H100 80GB HBM3, power limit 700.00 W (read by
# chip_smoke.py, which checks the budget against the card it runs on)
CARD_TOTAL_MEMORY = 85_017_493_504
HBM_BUDGET_BYTES = CARD_TOTAL_MEMORY
WRITE_HINT = "python -m ringpop_tpu_torch.analysis --prong scale --write"


def entry_budget(name: str, recording, spec: Optional[ranges.ScaleSpec] = None,
                 budget_bytes: int = HBM_BUDGET_BYTES) -> dict:
    """Footprint polynomial and feasible N\\* of one detailed recording."""
    spec = spec or ranges.entry_scale(name)
    poly = ranges.buffer_poly(recording, spec)
    n_star = ranges.feasible_n(poly, budget_bytes, spec.n_max)
    return {
        "poly_bytes": {str(e): c for e, c in sorted(poly.items())},
        "degree": max(poly) if poly else 0,
        "n_max": spec.n_max,
        "n_star": n_star,
        "ceiling_bound": n_star == spec.n_max,
    }


def collect_budgets(entry_names: Optional[Iterable[str]] = None,
                    budget_bytes: int = HBM_BUDGET_BYTES) -> Dict[str, dict]:
    """``name -> entry_budget`` over the registry (or a named subset); an
    entry that fails to run gives ``{"error": ...}``."""
    from ringpop_tpu_torch.analysis import graph_audit as ga

    wanted = [ep.name for ep in ga.DEFAULT_ENTRIES] if entry_names is None else list(entry_names)
    out: Dict[str, dict] = {}
    for name in sorted(wanted):
        ep = ga.ENTRIES_BY_NAME.get(name)
        if ep is None:
            out[name] = {"error": "unknown entry point"}
            continue
        try:
            out[name] = entry_budget(name, ga.recorded(ep, detail=True).recording,
                                     budget_bytes=budget_bytes)
        except Exception as e:
            out[name] = {"error": "%s: %s" % (type(e).__name__, e)}
    return out


def compare_to_manifest(actual: Dict[str, dict], manifest: dict,
                        rtol: float = DEFAULT_RTOL) -> List[Finding]:
    """Findings for every feasibility drift (JAX's verdicts): N\\*
    shrinking past ``rtol`` is a regression, growing past it a stale
    manifest; ``degree`` compares exactly; an entry on one side only, or
    one that failed, is a finding."""
    findings: List[Finding] = []

    def emit(name, rule, message):
        findings.append(Finding(rule=rule, path="<entry:%s>" % name, line=0, message=message,
                                prong=PRONG))

    expected = manifest.get("entries", {})
    for name, exp in sorted(expected.items()):
        act = actual.get(name)
        if act is None:
            emit(name, "scale-budget", "entry in manifest but not analyzed")
            continue
        if "error" in act:
            emit(name, "scale-failure", "entry failed to analyze: %s" % act["error"])
            continue
        if act.get("degree") != exp.get("degree"):
            emit(name, "scale-budget",
                 "footprint degree changed: O(N^%s) -> O(N^%s) — a new scaled plane; "
                 "regenerate with %s if intended" % (exp.get("degree"), act.get("degree"),
                                                     WRITE_HINT))
        ev, av = exp.get("n_star", 0), act.get("n_star", 0)
        if av < ev and (ev - av) > rtol * max(ev, 1):
            emit(name, "scale-budget",
                 "feasible ceiling N* shrank: %d -> %d (%.1f%%) — the entry fits fewer "
                 "nodes on the card than the committed budget; shrink the footprint or "
                 "regenerate with %s if intended"
                 % (ev, av, 100.0 * (ev - av) / max(ev, 1), WRITE_HINT))
        elif av > ev and (av - ev) > rtol * max(ev, 1):
            emit(name, "scale-budget",
                 "feasible ceiling N* grew: %d -> %d — stale manifest; bank the win with %s"
                 % (ev, av, WRITE_HINT))
    for name in sorted(set(actual) - set(expected)):
        act = actual[name]
        if "error" in act:
            emit(name, "scale-failure", "entry failed to analyze: %s" % act["error"])
        else:
            emit(name, "scale-budget", "entry has no manifest entry — regenerate with %s"
                 % WRITE_HINT)
    return findings


def write_manifest(actual: Dict[str, dict], path: Optional[Path] = None,
                   budget_bytes: int = HBM_BUDGET_BYTES) -> Path:
    """Commit collected budgets; refuses entries that failed."""
    manifests.refuse_failed(actual)
    return manifests.write(MANIFEST_NAME, {
        "version": 1,
        "hbm_budget_bytes": budget_bytes,
        "card": "NVIDIA H100 80GB HBM3, 700.00 W (torch.cuda total_memory)",
        "note": (
            "static scale budget of the PyTorch port: each entry's footprint polynomial "
            "in N and the feasible ceiling N* under the card's memory (see "
            "ringpop_tpu_torch/analysis/scale_budget.py).  Regenerate with "
            "'%s' after an intended footprint change." % WRITE_HINT
        ),
        "entries": actual,
    }, path)


def check_against_manifest(entry_names: Optional[Iterable[str]] = None,
                           path: Optional[Path] = None,
                           rtol: float = DEFAULT_RTOL) -> List[Finding]:
    """The gate: analyze and diff.  A named subset diffs only its slice of
    the manifest; a full run also catches the manifest's stale rows."""
    try:
        manifest = manifests.load(MANIFEST_NAME, path)
    except FileNotFoundError:
        return [Finding(rule="scale-budget", path=MANIFEST_NAME, line=0,
                        message="manifest missing — generate with %s" % WRITE_HINT,
                        prong=PRONG)]
    budget = int(manifest.get("hbm_budget_bytes", HBM_BUDGET_BYTES))
    actual = collect_budgets(entry_names, budget_bytes=budget)
    if entry_names is not None:
        manifest = dict(manifest, entries={k: v for k, v in manifest.get("entries", {}).items()
                                           if k in actual})
    return compare_to_manifest(actual, manifest, rtol=rtol)
