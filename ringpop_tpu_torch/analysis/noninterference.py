"""The ``noninterference`` prong: no obs-only input field of an entry point
reaches a trajectory output field.

Counterpart of ``ringpop_tpu/analysis/noninterference.py``.  Every obs
plane — the flight recorder (``ev_buf``/``ev_head``/``ev_drops``,
``first_heard``), the histograms (``hist``), the wavefront, the exchange
counters (``exch``/``exch_hist``), the request traces (``req_*``) — must be
invisible to the trajectory.  The card-against-CPU and planes-on-against-off
runs sample that property; this prong checks its dataflow half on each
recorded entry point: the entry's input leaves are labelled from the state
registries, its recording (:mod:`.graph_audit`, shared) is sliced
(:func:`.dataflow.slice_reachability`), and an obs leaf that reaches a
trajectory leaf is a finding naming the op chain it went through.

Field classes come from one registry per state class, beside the class:
``engine.SIM_*``, ``engine_scalable.SCALABLE_*``, ``plane.ROUTE_*``
(``tests/test_torch_analysis_noninterference.py`` keeps each total and
disjoint).  ``*Metrics`` tuples are observability sinks: obs state may flow
into them.  A recording follows the path the inputs took, where a jaxpr
holds every branch, so each obs entry starts from a state that runs its
planes (a kill in the first tick).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ringpop_tpu_torch.analysis import dataflow
from ringpop_tpu_torch.analysis.findings import Finding

PRONG = "noninterference"

# kinds a leaf can carry
KIND_TRAJ = "trajectory"
KIND_OBS = "obs-only"
KIND_METRICS = "metrics"
KIND_OTHER = "other"
KIND_UNCLASSIFIED = "unclassified"


@dataclasses.dataclass(frozen=True)
class Label:
    kind: str
    path: str  # e.g. "SimState.hist" or "args[1]"


def state_registries() -> Dict[str, Tuple[frozenset, frozenset]]:
    """class name -> (trajectory fields, obs-only fields)."""
    from ringpop_tpu_torch.models.route import plane
    from ringpop_tpu_torch.models.sim import engine, engine_scalable as es

    return {
        "SimState": (engine.SIM_TRAJECTORY_FIELDS, engine.SIM_OBS_ONLY_FIELDS),
        "ScalableState": (es.SCALABLE_TRAJECTORY_FIELDS, es.SCALABLE_OBS_ONLY_FIELDS),
        "RouteState": (plane.ROUTE_TRAJECTORY_FIELDS, plane.ROUTE_OBS_ONLY_FIELDS),
    }


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def label_tree(x, regs: Dict[str, Tuple[frozenset, frozenset]], path: str,
               kind: str = KIND_OTHER):
    """A structure-identical tree with a :class:`Label` at every leaf.
    Registered state classes label their fields from the registry;
    ``*Metrics`` tuples become metrics sinks; everything nested under a
    classified field inherits its class (a ``RingState`` inside
    ``RouteState.ring`` is trajectory).  An absent (None) field carries
    nothing and is labelled "other"."""
    if x is None:
        return Label(KIND_OTHER, path)
    if _is_namedtuple(x):
        cls = type(x).__name__
        if cls in regs:
            traj, obs = regs[cls]
            parts = []
            for f, v in zip(x._fields, x):
                k = KIND_OBS if f in obs else KIND_TRAJ if f in traj else KIND_UNCLASSIFIED
                parts.append(label_tree(v, regs, f"{cls}.{f}", k))
            return type(x)(*parts)
        sub_kind = KIND_METRICS if cls.endswith("Metrics") else kind
        return type(x)(*(
            label_tree(v, regs, f"{path or cls}.{f}", sub_kind) for f, v in zip(x._fields, x)
        ))
    if isinstance(x, (tuple, list)):
        return type(x)(label_tree(v, regs, f"{path}[{i}]", kind) for i, v in enumerate(x))
    if isinstance(x, dict):
        return {k: label_tree(v, regs, f"{path}[{k!r}]", kind) for k, v in x.items()}
    return Label(kind, path)


def _labels(x, regs, path: str) -> List[Label]:
    return dataflow.flatten(label_tree(x, regs, path))


def _finding(rule: str, name: str, message: str) -> Finding:
    return Finding(rule=rule, path=f"<entry:{name}>", line=0, message=message, prong=PRONG)


def check_entry(name: str, fn, args: Tuple, cache_as: Optional[str] = None) -> List[Finding]:
    """Check one entry point.  ``cache_as`` names a registered entry whose
    recording is shared with the graph prong; ad-hoc callers (the mutation
    tests' doctored entries) leave it None and record afresh."""
    from ringpop_tpu_torch.analysis import graph_audit as ga

    regs = state_registries()
    findings: List[Finding] = []
    cached = ga._TRACE_CACHE.get(cache_as) if cache_as is not None else None
    if cached is not None:
        args = cached.args  # label the very inputs the recording ran on
    in_labels = _labels(tuple(args), regs, "args")
    for lab in in_labels:
        if lab.kind == KIND_UNCLASSIFIED:
            findings.append(_finding(
                "unclassified-state-field", name,
                f"state field {lab.path} is in neither the trajectory nor the obs-only "
                "registry: classify it beside the state class (see "
                "engine.SIM_TRAJECTORY_FIELDS)"))
    if not any(lab.kind == KIND_OBS for lab in in_labels):
        return findings  # nothing to prove: no obs plane in this entry

    try:
        if cached is not None:
            rec = cached.recording
        elif cache_as is not None:
            # record these inputs and share the recording with the graph prong
            ep = ga.ENTRIES_BY_NAME[cache_as]
            ga._TRACE_CACHE[cache_as] = cached = ga.record_entry(cache_as, fn, args, ep.reads)
            rec = cached.recording
        else:
            rec = dataflow.record(fn, args)
    except Exception as e:
        findings.append(ga.trace_failure(name, e, PRONG))
        return findings
    if len(in_labels) != len(rec.input_values):
        findings.append(_finding(
            "trace-failure", name,
            f"label/recording mismatch: {len(in_labels)} labelled input leaves against "
            f"{len(rec.input_values)} recorded"))
        return findings

    reach = dataflow.slice_reachability(
        rec, [lab.path if lab.kind == KIND_OBS else None for lab in in_labels])
    out_labels = _labels(rec.out, regs, "out")
    if len(out_labels) != len(reach):
        findings.append(_finding(
            "trace-failure", name,
            f"label/recording mismatch: {len(out_labels)} labelled output leaves against "
            f"{len(reach)} recorded"))
        return findings
    for out_lab, reached in zip(out_labels, reach):
        if out_lab.kind != KIND_TRAJ or not reached:
            continue
        for src, witness in sorted(reached.items()):
            findings.append(_finding(
                "obs-interference", name,
                f"obs-only input {src} reaches trajectory output {out_lab.path} — the "
                "observability plane leaks into the compared state; op chain: "
                f"{dataflow.witness_chain(witness)}"))
    return findings


# The entries that carry an obs plane: JAX's nine, each by its port
# counterpart.  Entries outside the list are still checked by a full run
# (they prove vacuously: no obs input leaves).
OBS_ENTRY_NAMES: Tuple[str, ...] = (
    "engine-tick-flight-recorder",
    "engine-tick-histograms",
    "engine-scalable-tick-wavefront",
    "engine-scalable-tick-histograms",
    "route-tick-histograms",
    "route-tick-reqtrace",
    "fuzz-scan-full",
    # the mesh's exchange counters (two shard bodies in lockstep) and the
    # single-device twin's analytic ones
    "engine-scalable-tick-mesh-metrics",
    "engine-scalable-tick-exchange-metrics",
)

# JAX's OBS_ENTRY_NAMES -> the port entry standing for each
JAX_OBS_COUNTERPARTS: Dict[str, str] = {
    "engine-tick-scan-flight-recorder": "engine-tick-flight-recorder",
    "engine-tick-scan-histograms": "engine-tick-histograms",
    "engine-scalable-tick-wavefront": "engine-scalable-tick-wavefront",
    "engine-scalable-tick-histograms": "engine-scalable-tick-histograms",
    "route-tick-histograms": "route-tick-histograms",
    "route-tick-reqtrace": "route-tick-reqtrace",
    "fuzz-scenario-scan-full": "fuzz-scan-full",
    "engine-scalable-tick-shardmap-metrics": "engine-scalable-tick-mesh-metrics",
    "engine-scalable-tick-exchange-metrics": "engine-scalable-tick-exchange-metrics",
}

# module prefixes feeding each obs entry: the --changed-only mapping
ENTRY_SOURCES: Dict[str, Tuple[str, ...]] = {
    "engine-tick-flight-recorder": ("models/sim/engine.py", "models/sim/flight.py", "ops/"),
    "engine-tick-histograms": ("models/sim/engine.py", "ops/"),
    "engine-scalable-tick-wavefront": ("models/sim/engine_scalable.py", "ops/"),
    "engine-scalable-tick-histograms": ("models/sim/engine_scalable.py", "ops/"),
    "route-tick-histograms": ("models/route/", "ops/"),
    "route-tick-reqtrace": ("models/route/", "ops/"),
    "fuzz-scan-full": ("models/sim/engine.py", "models/sim/flight.py",
                       "models/sim/batched.py", "fuzz/executor.py", "ops/"),
    "engine-scalable-tick-mesh-metrics": ("models/sim/engine_scalable.py", "parallel/", "ops/"),
    "engine-scalable-tick-exchange-metrics": ("models/sim/engine_scalable.py", "ops/"),
}

# a touched file here re-checks every entry (the analysis itself, or a
# state registry)
GLOBAL_SOURCES: Tuple[str, ...] = (
    "analysis/",
    "models/sim/engine.py",
    "models/sim/engine_scalable.py",
    "models/route/plane.py",
)


def entries_for_changed(rel_paths: Iterable[str]) -> List[str]:
    """Affected entry names for changed package-relative paths
    (``models/sim/flight.py``); an empty list skips the prong."""
    rels = list(rel_paths)
    if any(r.startswith(GLOBAL_SOURCES) for r in rels):
        return list(OBS_ENTRY_NAMES)
    return [name for name, sources in ENTRY_SOURCES.items()
            if any(r.startswith(sources) for r in rels)]


def check_noninterference(entry_names: Optional[Sequence[str]] = None) -> List[Finding]:
    """The prong over the registered entries (``None``: every entry of the
    graph prong's registry; those without an obs input prove vacuously and
    record nothing)."""
    from ringpop_tpu_torch.analysis import graph_audit as ga

    names = list(ga.ENTRIES_BY_NAME) if entry_names is None else list(entry_names)
    findings: List[Finding] = []
    for name in names:
        ep = ga.ENTRIES_BY_NAME.get(name)
        if ep is None:
            findings.append(_finding("trace-failure", name, "unknown entry point"))
            continue
        cached = ga._TRACE_CACHE.get(name)
        try:
            fn, args = (None, cached.args) if cached is not None else ep.build()
        except Exception as e:
            findings.append(_finding(
                "trace-failure", name,
                f"entry point setup failed: {type(e).__name__}: {e}"))
            continue
        findings.extend(check_entry(name, fn, args, cache_as=name))
    return findings
