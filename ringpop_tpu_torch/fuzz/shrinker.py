"""Schedule shrinker: failing seed -> minimal reproducing fault schedule.

Counterpart of ``ringpop_tpu/fuzz/shrinker.py``, over the port's
executors.  Strategy (every candidate runs at the original [T, N] shapes):

1. **tick-tail bisect** — binary-search the shortest schedule prefix
   whose faults alone still violate, then
2. **per-tick fault-set ddmin** — delta-debug the surviving sparse fault
   cells down to a 1-minimal set.

Candidate evaluation is batched: each ddmin round packs its candidate
fault subsets into one executor pass.  The result serializes as a
regression fixture (JSON, the JAX module's format 1): engine, shapes, the
minimal sparse fault list, the violated invariant names and the init seed;
``replay_fixture`` rebuilds the schedule, re-runs it and re-checks the
invariants, so the fixtures committed under tests/fuzz/fixtures/ replay on
the port too.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

from ringpop_tpu_torch.fuzz import invariants, scenarios
from ringpop_tpu_torch.fuzz.scenarios import ScenarioConfig

Fault = Tuple[str, int, int, int]

FIXTURE_FORMAT = 1


class ShrinkResult(NamedTuple):
    config: ScenarioConfig
    seed: int  # init-state seed the instance ran under
    packet_loss: float
    faults: Tuple[Fault, ...]  # the minimal reproducing fault set
    violations: Tuple[invariants.Violation, ...]  # on the minimal schedule
    evaluations: int  # schedules executed during the shrink
    original_faults: int

    @property
    def invariant_names(self) -> List[str]:
        return invariants.violation_names(self.violations)


def _check_batch(
    executor: Any,
    fault_sets: Sequence[Sequence[Fault]],
    seed: int,
    contract: Optional[Any],
    target: Optional[set],
) -> List[Tuple[bool, List[invariants.Violation]]]:
    """Run a batch of candidate fault sets; per candidate, does the run
    still violate (restricted to ``target`` invariant names if given)?"""
    cfg = executor.config
    scheds = [
        scenarios.schedule_from_faults(
            cfg.engine, cfg.n, cfg.ticks, list(fs), config=cfg
        )
        for fs in fault_sets
    ]
    # pad the candidate batch to a power of two (repeats of the first
    # candidate, results discarded), as the JAX shrinker does to bound its
    # compiles: the same batches run, so both shrinks take the same path
    want = 1
    while want < len(scheds):
        want *= 2
    padded = scheds + [scheds[0]] * (want - len(scheds))
    run = executor.run_schedules(padded, seeds=[seed] * len(padded))
    # trim the padding duplicates BEFORE checking: the invariant pass is
    # the host-side cost of a shrink round, and the padded instances'
    # results are discarded anyway
    k = len(fault_sets)
    run = run._replace(
        seeds=run.seeds[:k],
        schedules=run.schedules[:k],
        final_state=invariants._instance_prefix(run.final_state, k),
        metrics=invariants._instance_prefix(run.metrics, k),
        events=None if run.events is None else run.events[:k],
        drops=None if run.drops is None else run.drops[:k],
    )
    by_instance = invariants.check_run(run, contract=contract)
    out = []
    for b in range(len(fault_sets)):
        vs = by_instance.get(b, [])
        if target is not None:
            vs = [v for v in vs if v.invariant in target]
        out.append((bool(vs), vs))
    return out


def shrink(
    executor: Any,  # a fuzz executor (its batch shape is reused as-is)
    faults: Sequence[Fault],
    seed: int,
    contract: Optional[Any] = None,
    target: Optional[Sequence[str]] = None,
    max_rounds: int = 24,
) -> ShrinkResult:
    """Minimize ``faults`` while the run keeps violating.

    ``target`` restricts "still failing" to the named invariants (so the
    shrink cannot wander onto an unrelated violation); default: the
    invariants the full fault set violates."""
    faults = sorted(faults)
    n_original = len(set(faults))
    tgt = set(target) if target is not None else None
    evaluations = 0

    def failing(cands: Sequence[Sequence[Fault]]):
        nonlocal evaluations
        evaluations += len(cands)
        return _check_batch(executor, cands, seed, contract, tgt)

    (fails0, vs0), = failing([faults])
    if not fails0:
        raise ValueError(
            "schedule does not violate the target invariants — nothing "
            "to shrink"
        )
    if tgt is None:
        tgt = set(invariants.violation_names(vs0))

    # -- stage 1: tick-tail bisect --------------------------------------
    def prefix(fs: Sequence[Fault], rows: int) -> List[Fault]:
        return [f for f in fs if f[1] < rows]

    lo, hi = 1, executor.config.ticks  # smallest prefix that still fails
    while lo < hi:
        mid = (lo + hi) // 2
        (bad, _), = failing([prefix(faults, mid)])
        if bad:
            hi = mid
        else:
            lo = mid + 1
    faults = prefix(faults, lo)

    # -- stage 2: ddmin over the fault cells ----------------------------
    chunks = 2
    rounds = 0
    while len(faults) > 1 and rounds < max_rounds:
        rounds += 1
        size = max(1, len(faults) // chunks)
        complements = []
        spans = []
        for start in range(0, len(faults), size):
            keep = faults[:start] + faults[start + size:]
            if keep:
                complements.append(keep)
                spans.append((start, start + size))
        if not complements:
            break
        results = failing(complements)
        for (bad, _), keep in zip(results, complements):
            if bad:
                faults = keep
                chunks = max(chunks - 1, 2)
                break
        else:
            if size == 1:
                break
            chunks = min(len(faults), chunks * 2)

    (bad, vs), = failing([faults])
    assert bad, "shrink invariant: the minimal schedule must still fail"
    return ShrinkResult(
        config=executor.config,
        seed=int(seed),
        packet_loss=float(getattr(executor.params, "packet_loss", 0.0)),
        faults=tuple(faults),
        violations=tuple(vs),
        evaluations=evaluations,
        original_faults=n_original,
    )


def shrink_seed(
    executor: Any,
    seed: int,
    contract: Optional[Any] = None,
    target: Optional[Sequence[str]] = None,
) -> ShrinkResult:
    """Shrink the schedule that ``generate(seed)`` produces."""
    sched = scenarios.generate(seed, executor.config)
    faults = scenarios.sparse_faults(sched, executor.config.engine)
    return shrink(executor, faults, seed, contract=contract, target=target)


# -- fixture serialization ---------------------------------------------------


def fixture_dict(result: ShrinkResult, note: str = "") -> Dict[str, Any]:
    cfg = result.config
    return {
        "format": FIXTURE_FORMAT,
        "engine": cfg.engine,
        "n": cfg.n,
        "ticks": cfg.ticks,
        "seed": result.seed,
        "packet_loss": result.packet_loss,
        "use_leave": cfg.use_leave,
        "use_resume": cfg.use_resume,
        "faults": [list(f) for f in result.faults],
        "invariants": result.invariant_names,
        "note": note,
    }


def save_fixture(result: ShrinkResult, path: str, note: str = "") -> None:
    with open(path, "w") as f:
        json.dump(fixture_dict(result, note), f, indent=2, sort_keys=True)
        f.write("\n")


def load_fixture(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != FIXTURE_FORMAT:
        raise ValueError(
            "%s: fixture format %r, this build reads %d"
            % (path, doc.get("format"), FIXTURE_FORMAT)
        )
    return doc


def replay_fixture(
    path_or_doc: Any,
    contract: Optional[Any] = None,
    device=None,
) -> List[invariants.Violation]:
    """Rebuild a fixture's minimal schedule, run it on the CURRENT
    engines (on the card unless ``device="cpu"``), and return the
    violations (empty == the bug stayed fixed)."""
    from ringpop_tpu_torch.fuzz import executor as ex

    doc = (
        load_fixture(path_or_doc)
        if isinstance(path_or_doc, str)
        else path_or_doc
    )
    cfg = ScenarioConfig(
        engine=doc["engine"],
        n=int(doc["n"]),
        ticks=int(doc["ticks"]),
        use_leave=bool(doc.get("use_leave", True)),
        use_resume=bool(doc.get("use_resume", True)),
    )
    executor = ex.executor_for(
        cfg,
        packet_loss=float(doc.get("packet_loss", 0.0)),
        device=device,
    )
    sched = scenarios.schedule_from_faults(
        cfg.engine,
        cfg.n,
        cfg.ticks,
        [tuple(f) for f in doc["faults"]],
        config=cfg,
    )
    run = executor.run_schedules([sched], seeds=[int(doc.get("seed", 0))])
    return invariants.check_run(run, contract=contract).get(0, [])
