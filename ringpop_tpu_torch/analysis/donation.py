"""The ``donation`` prong: the aliasing surface of the drivers' ticks
against ``budgets/DONATION_BUDGET.json``.

Counterpart of ``ringpop_tpu/analysis/donation.py``, which pins the
``input_output_alias`` map of every donating jitted driver.  Torch has no
donation: a tick returns new tensors, and the hazards JAX's prong guards
are in-place writes and aliasing — the class of PR 7's live-state aliasing
flake, where a caller's old and new state shared memory and a later write
changed both.  Two are visible in a detailed recording
(:mod:`.dataflow`), per entry and by field path:

- ``written_inputs``: the input leaves the entry writes in place (a new
  version of an input storage);
- ``aliased_outputs``: the output leaves that share a storage with an
  input leaf (``"ScalableState.partition <- ScalableState.partition"``): a
  field the tick passes through, whose old and new state are one tensor.

Both are pinned in the manifest with the leaf counts; a change either way
is ``donation-budget`` (JAX's rule id), an entry that fails to run is
``donation-failure``.  ``inplace-input-write`` is the torch rule: an
input leaf written in place that :data:`DECLARED_INPLACE` does not declare
with its reason.  It is a rule of its own, not a drift, because such a
write changes the caller's state behind its back — the bounded-parity
replay re-runs a tick from its input state, and a checkpoint or a twin
holding the old state would read the new — and ``--write`` refuses it,
as JAX's ``--write`` refuses a dropped donation.

The entries are JAX's five donating drivers' counterparts (the scalable
tick and its windowed run, the routed tick and its windowed run, the mesh
storm's tick) plus the wavefront tick, whose ``first_heard`` column the
publish writes in place into the tick's own copy (``engine_scalable``,
the write ``astlint``'s ``inplace-on-state`` suppresses with that reason).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ringpop_tpu_torch.analysis import dataflow, manifests
from ringpop_tpu_torch.analysis.findings import Finding

PRONG = "donation"
MANIFEST_NAME = "DONATION_BUDGET.json"
WRITE_HINT = "python -m ringpop_tpu_torch.analysis --prong donation --write"
N = 8

# entry -> {input field path: why the entry may write it in place}
DECLARED_INPLACE: Dict[str, Dict[str, str]] = {}


@dataclasses.dataclass(frozen=True)
class DonationEntry:
    name: str
    build: Callable[[], Tuple[Callable, Tuple]]  # () -> (fn, args)


def _scalable_params(**kw):
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    return es.resolve_scalable_params(es.ScalableParams(n=N, u=128, **kw), "cpu")


def _kill_inputs():
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    kill = torch.zeros(N, dtype=torch.bool)
    kill[N - 1] = True
    return es.ChurnInputs(kill=kill, revive=torch.zeros(N, dtype=torch.bool))


def _schedule(t: int = 2):
    from ringpop_tpu_torch.models.sim.storm import StormSchedule

    return StormSchedule.churn_storm(t, N, fraction=0.25, fail_tick=0)


def _entry_scalable_tick(**kw):
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    params = _scalable_params(**kw)
    state = es.init_state(params, seed=0, device="cpu")
    return (lambda s, i: es.tick(s, i, params)), (state, _kill_inputs())


def _entry_scalable_scan():
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster

    cl = ScalableCluster(N, params=_scalable_params(), device="cpu")
    sched = _schedule()

    def run(state):
        cl.state = state
        cl._run_window(sched)
        return cl.state

    return run, (cl.state,)


def _routed():
    from ringpop_tpu_torch.models.route import plane

    route = plane.RouteParams(n=N, replica_points=4, bucket_bits=2, queries_per_tick=16,
                              key_space=64, max_changed=4, max_dirty=4)
    return plane.RoutedStorm(N, params=_scalable_params(), route=route, replica_points=4,
                             device="cpu")


def _entry_routed_tick():
    rs = _routed()

    def tick(carry, inputs):
        rs.cluster.state, rs.rstate = carry
        em, rm = rs._tick(inputs)
        return (rs.cluster.state, rs.rstate), em, rm

    return tick, ((rs.cluster.state, rs.rstate), _kill_inputs())


def _entry_routed_scan():
    rs = _routed()
    sched = _schedule()

    def run(carry):
        rs.cluster.state, rs.rstate = carry
        rs._run_window(sched)
        return rs.cluster.state, rs.rstate

    return run, ((rs.cluster.state, rs.rstate),)


def _entry_mesh_storm_tick():
    from ringpop_tpu_torch.parallel import mesh as pmesh

    storm = pmesh.ShardedStorm(N, mesh=pmesh.make_mesh(2, device="cpu"),
                               params=_scalable_params(perm_impl="sortless",
                                                       fused_exchange="plain"), seed=0)
    inputs = _kill_inputs()

    def tick(states):
        storm._states = list(states)
        shard_inputs = storm._split_inputs({storm.mesh.devices[0]: inputs})
        m = storm._tick(shard_inputs)
        return storm._states, m

    return tick, (list(storm.shard_states),)


DEFAULT_ENTRIES: List[DonationEntry] = [
    DonationEntry("scalable-tick", _entry_scalable_tick),
    DonationEntry("scalable-tick-wavefront", lambda: _entry_scalable_tick(wavefront=True)),
    DonationEntry("scalable-scan", _entry_scalable_scan),
    DonationEntry("routed-tick", _entry_routed_tick),
    DonationEntry("routed-scan", _entry_routed_scan),
    DonationEntry("mesh-storm-tick", _entry_mesh_storm_tick),
]

# JAX's DONATION_BUDGET entries -> the port entry standing for each
JAX_COUNTERPARTS: Dict[str, str] = {
    "scalable-tick": "scalable-tick",
    "scalable-scan": "scalable-scan",
    "routed-tick": "routed-tick",
    "routed-scan": "routed-scan",
    "mesh-storm-tick": "mesh-storm-tick",
}

# module prefixes that can move the surface: the --changed-only gate
SOURCES: Tuple[str, ...] = (
    "models/sim/storm.py",
    "models/sim/engine_scalable.py",
    "models/route/",
    "parallel/mesh.py",
    "analysis/",
)


def surface(recording: dataflow.Recording, args) -> dict:
    """The aliasing surface of one detailed recording (module docstring)."""
    from ringpop_tpu_torch.analysis import ranges

    in_names, out_names = ranges.leaf_names(recording, args)
    by_vid: Dict[int, List[str]] = {}
    for vid, name in zip(recording.input_values, in_names):
        if vid is not None:
            by_vid.setdefault(vid, []).append(name)
    written = set()
    for op in recording.ops:
        for old, _ in op.writes:
            written.update(by_vid.get(recording.roots.get(old, old), ()))
    aliased = set()
    for root, name in zip(recording.output_roots, out_names):
        for src in by_vid.get(root, ()) if root is not None else ():
            aliased.add("%s <- %s" % (name, src))
    return {
        "input_leaves": sum(v is not None for v in recording.input_values),
        "output_leaves": sum(v is not None for v in recording.output_values),
        "written_inputs": sorted(written),
        "aliased_outputs": sorted(aliased),
    }


def collect(entry_names: Optional[Iterable[str]] = None,
            entries: Optional[List[DonationEntry]] = None) -> Dict[str, dict]:
    """Record each entry (warmed once) and extract its surface; an entry
    that fails gives ``{"error": ...}``."""
    by_name = {e.name: e for e in (DEFAULT_ENTRIES if entries is None else entries)}
    wanted = sorted(by_name if entry_names is None else set(entry_names))
    out: Dict[str, dict] = {}
    for name in wanted:
        e = by_name.get(name)
        if e is None:
            out[name] = {"error": "unknown donation entry"}
            continue
        try:
            fn, args = e.build()
            fn(*args)  # warm: per-device tables upload on first use
            fn, args = e.build()
            out[name] = surface(dataflow.record(fn, args, detail=True), args)
        except Exception as exc:
            out[name] = {"error": "%s: %s" % (type(exc).__name__, exc)}
    return out


def undeclared_writes(name: str, act: dict) -> List[str]:
    declared = DECLARED_INPLACE.get(name, {})
    return [w for w in act.get("written_inputs", ()) if w not in declared]


def compare_to_manifest(actual: Dict[str, dict], manifest: dict) -> List[Finding]:
    findings: List[Finding] = []

    def emit(rule, name, msg):
        findings.append(Finding(rule=rule, path="<entry:%s>" % name, line=0, message=msg,
                                prong=PRONG))

    for name, act in sorted(actual.items()):
        if "error" not in act:
            for w in undeclared_writes(name, act):
                emit("inplace-input-write", name,
                     "the entry writes its input leaf %s in place: the caller's state "
                     "changes behind it (a replay, a twin or a checkpoint holding it reads "
                     "the new values); write a copy, or declare it in "
                     "donation.DECLARED_INPLACE with its reason" % w)
    expected = manifest.get("entries", {})
    for name, exp in sorted(expected.items()):
        act = actual.get(name)
        if act is None:
            emit("donation-budget", name, "entry in manifest but not measured")
            continue
        if "error" in act:
            emit("donation-failure", name, "entry failed to run: %s" % act["error"])
            continue
        for key in ("input_leaves", "output_leaves", "written_inputs", "aliased_outputs"):
            if act.get(key) != exp.get(key):
                emit("donation-budget", name,
                     "%s changed: measured %r vs manifest %r — regenerate with %s if "
                     "intended" % (key, act.get(key), exp.get(key), WRITE_HINT))
    for name in sorted(set(actual) - set(expected)):
        act = actual[name]
        if "error" in act:
            emit("donation-failure", name, "entry failed to run: %s" % act["error"])
        else:
            emit("donation-budget", name, "entry has no manifest entry — regenerate with %s"
                 % WRITE_HINT)
    return findings


def write_manifest(actual: Dict[str, dict], path: Optional[Path] = None) -> Path:
    """Commit the surfaces; refuses failed entries and undeclared in-place
    writes (a manifest never blesses one)."""
    manifests.refuse_failed(actual)
    undeclared = {n: undeclared_writes(n, a) for n, a in actual.items()
                  if undeclared_writes(n, a)}
    if undeclared:
        raise ValueError("refusing to write a manifest with undeclared in-place writes to "
                         "inputs: %r" % (undeclared,))
    return manifests.write(MANIFEST_NAME, {
        "version": 1,
        "backend": "cpu",
        "torch_version": torch.__version__,
        "note": (
            "aliasing surface of the PyTorch port's drivers: the input leaves each entry "
            "writes in place and the output leaves sharing an input's storage (see "
            "ringpop_tpu_torch/analysis/donation.py).  Regenerate with '%s' after an "
            "intended change." % WRITE_HINT
        ),
        "entries": actual,
    }, path)


def check_against_manifest(entry_names: Optional[Iterable[str]] = None,
                           path: Optional[Path] = None,
                           entries: Optional[List[DonationEntry]] = None) -> List[Finding]:
    """The gate: record and diff (a named subset diffs its slice)."""
    try:
        manifest = manifests.load(MANIFEST_NAME, path)
    except FileNotFoundError:
        return [Finding(rule="donation-budget", path=MANIFEST_NAME, line=0,
                        message="manifest missing — generate with %s" % WRITE_HINT,
                        prong=PRONG)]
    actual = collect(entry_names, entries)
    if entry_names is not None:
        manifest = dict(manifest, entries={k: v for k, v in manifest.get("entries", {}).items()
                                           if k in actual})
    return compare_to_manifest(actual, manifest)
