"""The ``cost`` prong: a static cost manifest of every registered entry
point (``budgets/COST_BUDGET.json``).

Counterpart of ``ringpop_tpu/analysis/cost.py``, which pins XLA's
``cost_analysis`` and ``memory_analysis`` of each compiled entry.  Eager
PyTorch compiles nothing, so the torch form reads the same quantities off
the entry's recording (the graph prong's registry and cache, recorded with
``detail`` at toy size on the CPU):

- ``ops``: aten ops recorded;
- ``bytes_accessed``: each op's input and output bytes, views excluded;
- ``elements_written``: elements of every new storage and in-place write;
- ``argument_size_in_bytes``, ``output_size_in_bytes``: the entry's input
  and output leaves (each storage once);
- ``temp_size_in_bytes``: every other new storage;
- ``peak_bytes``: argument + output + temp bytes, as JAX's.

A widened plane, a new temp or an O(N) -> O(N^2) blowup moves them far
outside :data:`DEFAULT_RTOL` (0.1, both directions).  A kernel wrapper's
entry records its plain version (its tensors are on the CPU); the recorder
does not see a ``ctypes`` launch, so there is no card manifest.  The
manifest records ``backend: cpu`` (every recording runs there, so the gate
always compares, where JAX's skips another backend) and the torch version
it was made with: torch 2.11 on the card's host matched the 2.13 manifest
within the tolerance on every entry.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

from ringpop_tpu_torch.analysis import manifests
from ringpop_tpu_torch.analysis.findings import Finding

PRONG = "cost"
MANIFEST_NAME = "COST_BUDGET.json"
DEFAULT_RTOL = 0.1
WRITE_HINT = "python -m ringpop_tpu_torch.analysis --prong cost --write"

_ITEMSIZE = {"bool": 1, "uint8": 1, "int8": 1, "int16": 2, "uint16": 2, "float16": 2,
             "bfloat16": 2, "int32": 4, "uint32": 4, "float32": 4, "int64": 8, "uint64": 8,
             "float64": 8, "complex64": 8, "complex128": 16}


def _nbytes(shape, dtype: str) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * _ITEMSIZE.get(dtype.replace("torch.", ""), 4)


def costs_of(recording) -> dict:
    """The static costs of one detailed recording (module docstring)."""
    if not recording.detail:
        raise ValueError("cost needs a recording made with detail=True")
    accessed = written = alloc = 0
    out_roots = {r for r in recording.output_roots if r is not None}
    out_new = 0
    for op in recording.ops:
        new = [(s, d) for s, d, a in zip(op.out_shapes, op.out_dtypes, op.out_alloc) if a]
        wrote = [(s, d) for s, d, v in zip(op.out_shapes, op.out_dtypes, op.outputs)
                 if v is not None and any(v == nv for _, nv in op.writes)]
        if not new and not wrote:
            continue  # a view (or a host read): nothing moved
        accessed += sum(_nbytes(s, d) for s, d in zip(op.in_shapes, op.in_dtypes))
        accessed += sum(_nbytes(s, d) for s, d in zip(op.out_shapes, op.out_dtypes))
        written += sum(_nbytes(s, "int8") for s, _ in new + wrote)
        alloc += sum(_nbytes(s, d) for s, d in new)
        out_new += sum(_nbytes(s, d) for s, d, a, v in zip(op.out_shapes, op.out_dtypes,
                                                            op.out_alloc, op.outputs)
                       if a and v in out_roots)
    args = _leaf_bytes(recording.input_values, recording.input_meta)
    outs = _leaf_bytes(recording.output_values, recording.output_meta)
    temp = max(alloc - out_new, 0)
    return {
        "ops": len(recording.ops),
        "bytes_accessed": accessed,
        "elements_written": written,
        "argument_size_in_bytes": args,
        "output_size_in_bytes": outs,
        "temp_size_in_bytes": temp,
        "peak_bytes": args + outs + temp,
    }


def _leaf_bytes(vids, metas) -> int:
    seen, total = set(), 0
    for v, meta in zip(vids, metas):
        if v is None or meta is None or v in seen:
            continue
        seen.add(v)
        total += _nbytes(meta[0], meta[1])
    return total


def collect_costs(entry_names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """``name -> costs_of`` over the registry (or a named subset); an entry
    that fails to run gives ``{"error": ...}``."""
    from ringpop_tpu_torch.analysis import graph_audit as ga

    wanted = [ep.name for ep in ga.DEFAULT_ENTRIES] if entry_names is None else list(entry_names)
    out: Dict[str, dict] = {}
    for name in sorted(wanted):
        ep = ga.ENTRIES_BY_NAME.get(name)
        if ep is None:
            out[name] = {"error": "unknown entry point"}
            continue
        try:
            out[name] = costs_of(ga.recorded(ep, detail=True).recording)
        except Exception as e:
            out[name] = {"error": "%s: %s" % (type(e).__name__, e)}
    return out


def _drifted(actual: float, expected: float, rtol: float) -> bool:
    if actual == expected:
        return False
    return abs(actual - expected) > rtol * max(abs(expected), 1.0)


def compare_to_manifest(actual: Dict[str, dict], manifest: dict,
                        rtol: float = DEFAULT_RTOL) -> List[Finding]:
    """Findings for every drift or failure (JAX's verdicts): a metric past
    ``rtol`` either way, a metric or an entry on one side only, a failed
    entry."""
    findings: List[Finding] = []

    def emit(name, rule, message):
        findings.append(Finding(rule=rule, path="<entry:%s>" % name, line=0, message=message,
                                prong=PRONG))

    expected = manifest.get("entries", {})
    for name, exp in sorted(expected.items()):
        act = actual.get(name)
        if act is None:
            emit(name, "cost-budget", "entry in manifest but not measured")
            continue
        if "error" in act:
            emit(name, "cost-failure", "entry failed to run: %s" % act["error"])
            continue
        for key in sorted(set(exp) | set(act)):
            ev, av = exp.get(key), act.get(key)
            if ev is None or av is None:
                emit(name, "cost-budget", "metric %r present on only one side (manifest %r, "
                     "measured %r)" % (key, ev, av))
            elif _drifted(av, ev, rtol):
                emit(name, "cost-budget",
                     "%s: measured %d vs manifest %d (%+.1f%%) — %s; regenerate with %s if "
                     "intended" % (key, av, ev, 100.0 * (av - ev) / max(ev, 1),
                                   "cost regression" if av > ev else "stale manifest",
                                   WRITE_HINT))
    for name in sorted(set(actual) - set(expected)):
        act = actual[name]
        if "error" in act:
            emit(name, "cost-failure", "entry failed to run: %s" % act["error"])
        else:
            emit(name, "cost-budget", "entry has no manifest entry — regenerate with %s"
                 % WRITE_HINT)
    return findings


def write_manifest(actual: Dict[str, dict], path: Optional[Path] = None) -> Path:
    """Commit collected costs; refuses entries that failed."""
    manifests.refuse_failed(actual)
    return manifests.write(MANIFEST_NAME, {
        "version": 1,
        "backend": "cpu",
        "torch_version": torch.__version__,
        "note": (
            "static cost budget of the PyTorch port: each entry's recorded aten ops at its "
            "toy shape on the CPU (see ringpop_tpu_torch/analysis/cost.py).  Regenerate "
            "with '%s' after an intended cost change." % WRITE_HINT
        ),
        "entries": actual,
    }, path)


def check_against_manifest(entry_names: Optional[Iterable[str]] = None,
                           path: Optional[Path] = None,
                           rtol: float = DEFAULT_RTOL) -> List[Finding]:
    """The gate: collect and diff (a named subset diffs its slice)."""
    try:
        manifest = manifests.load(MANIFEST_NAME, path)
    except FileNotFoundError:
        return [Finding(rule="cost-budget", path=MANIFEST_NAME, line=0,
                        message="manifest missing — generate with %s" % WRITE_HINT,
                        prong=PRONG)]
    actual = collect_costs(entry_names)
    if entry_names is not None:
        manifest = dict(manifest, entries={k: v for k, v in manifest.get("entries", {}).items()
                                           if k in actual})
    return compare_to_manifest(actual, manifest, rtol=rtol)
