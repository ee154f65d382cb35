"""The ``retrace`` prong: what reloads or re-uploads silently, probed
against ``budgets/RETRACE_BUDGET.json``.

Counterpart of ``ringpop_tpu/analysis/retrace.py``, which counts a fresh
jit's cache entries after a fixed call sequence.  Eager PyTorch has no jit
cache; what recompiles or reloads silently here is:

- the kernel library (``ops/_build.py``): built once per source digest,
  loaded once a process (``_build.BUILDS`` counts the compiles);
- the per-device constant tables (:func:`device_tables`: the powers of
  ten, the coprime inverses, the status tables), each uploaded once per
  device — an upload inside a tick is a synchronous copy on the card;
- the ``torch.library`` custom ops of namespace ``toolkit.LIB`` and their
  ``register_vmap`` rules, registered once when their module is imported.

Each probe drives one entry through JAX's sequence: the canonical call,
the same shapes with other values, another shape (or structure).  Before
the first step the per-device tables are dropped (as JAX's probe clears
its caches); after every step it records the host-table uploads the step
made (the recorder's ``lift_fresh`` of a tensor of one dimension or
more), the tables cached, the library builds since the probe began and
the custom ops registered.  The sequences are pinned in the manifest; a difference
either way is ``retrace-budget``, a probe that fails ``probe-failure``.
``chip_smoke.py`` runs the probes on CUDA operands, the second and third
steps under ``torch.cuda.set_sync_debug_mode("error")`` where the entry
reads nothing on the host.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ringpop_tpu_torch.analysis import dataflow, manifests
from ringpop_tpu_torch.analysis.findings import Finding

PRONG = "retrace"
MANIFEST_NAME = "RETRACE_BUDGET.json"
WRITE_HINT = "python -m ringpop_tpu_torch.analysis --prong retrace --write"
N = 8


def device_tables() -> int:
    """The tables cached in the per-device constant caches."""
    from ringpop_tpu_torch.models.sim import engine, engine_scalable as es
    from ringpop_tpu_torch.ops import checksum_encode as ce, fused_checksum as fc

    return (len(ce._POW10_TABLES) + len(engine._COPRIME_INVS) + len(es._POW10)
            + fc._status_tables.cache_info().currsize)


def clear_device_tables() -> None:
    from ringpop_tpu_torch.models.sim import engine, engine_scalable as es
    from ringpop_tpu_torch.ops import checksum_encode as ce, fused_checksum as fc

    ce._POW10_TABLES.clear()
    engine._COPRIME_INVS.clear()
    es._POW10.clear()
    fc._status_tables.cache_clear()


def custom_ops() -> int:
    """Ops registered in the port's ``torch.library`` namespace."""
    from ringpop_tpu_torch.ops import toolkit

    prefix = toolkit.LIB + "::"
    return sum(1 for name in torch._C._dispatch_get_all_op_names() if name.startswith(prefix))


def library_builds() -> int:
    from ringpop_tpu_torch.ops import _build

    return _build.BUILDS


@dataclasses.dataclass(frozen=True)
class Probe:
    name: str
    # device -> (fn, [(step description, args), ...])
    build: Callable[[str], Tuple[Callable, List[Tuple[str, Tuple]]]]
    straight: bool = True  # reads nothing on the host (the card runs it under sync "error")


def run_probe(probe: Probe, device="cpu", sync_error: bool = False) -> List[dict]:
    """Drive one probe; ``sync_error`` runs the steps after the first under
    ``torch.cuda.set_sync_debug_mode("error")`` (a card, a straight probe)."""
    fn, steps = probe.build(device)
    clear_device_tables()
    builds0 = library_builds()
    out: List[dict] = []
    for i, (desc, args) in enumerate(steps):
        rec = dataflow.Recorder(track=False)
        strict = sync_error and i > 0 and probe.straight
        prev = torch.cuda.get_sync_debug_mode() if strict else None
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with rec:
                fn(*args)
        finally:
            if strict:
                torch.cuda.set_sync_debug_mode(prev)
        out.append({"desc": desc, "uploads": rec.uploads, "device_tables": device_tables(),
                    "library_builds": library_builds() - builds0, "custom_ops": custom_ops()})
    return out


def run_probes(probes: Optional[Iterable[Probe]] = None, device="cpu",
               sync_error: bool = False) -> Dict[str, list]:
    """Run every probe; a broken one gives a single ``{"error": ...}`` step."""
    from ringpop_tpu_torch.ops import (  # noqa: F401  every custom op registered first
        block_loop, exchange, fused_apply, fused_checksum, fused_piggyback, stream_hash)

    out: Dict[str, list] = {}
    for p in DEFAULT_PROBES if probes is None else probes:
        try:
            out[p.name] = run_probe(p, device, sync_error)
        except Exception as e:
            out[p.name] = [{"error": "%s: %s" % (type(e).__name__, e)}]
    return out


_KEYS = ("uploads", "device_tables", "library_builds", "custom_ops")


def compare_to_manifest(actual: Dict[str, list], manifest: dict) -> List[Finding]:
    """JAX's verdicts: a probe on one side only, a failed probe, another
    step count, and any step's count differing either way."""
    findings: List[Finding] = []

    def emit(rule, name, msg):
        findings.append(Finding(rule=rule, path="<probe:%s>" % name, line=0, message=msg,
                                prong=PRONG))

    expected = manifest.get("probes", {})
    for name, exp_steps in sorted(expected.items()):
        if name not in actual:
            emit("retrace-budget", name, "probe in manifest but not run")
            continue
        act_steps = actual[name]
        err = next((s["error"] for s in act_steps if "error" in s), None)
        if err is not None:
            emit("probe-failure", name, "probe failed to run: %s" % err)
            continue
        if len(act_steps) != len(exp_steps):
            emit("retrace-budget", name, "step count changed: manifest %d, probe ran %d"
                 % (len(exp_steps), len(act_steps)))
            continue
        for i, (exp, act) in enumerate(zip(exp_steps, act_steps)):
            for key in _KEYS:
                if act.get(key) != exp.get(key):
                    more = (act.get(key) or 0) > (exp.get(key) or 0)
                    emit("retrace-budget", name,
                         "step %d (%s): %s %r != manifest %r — %s" % (
                             i, act["desc"], key, act.get(key), exp.get(key),
                             "a silent reload or upload" if more else
                             "stale manifest (fewer than committed); regenerate with "
                             + WRITE_HINT))
    for name in sorted(set(actual) - set(expected)):
        err = next((s["error"] for s in actual[name] if "error" in s), None)
        if err is not None:
            emit("probe-failure", name, "probe failed to run: %s" % err)
        else:
            emit("retrace-budget", name, "probe has no manifest entry — regenerate with %s"
                 % WRITE_HINT)
    return findings


def write_manifest(actual: Dict[str, list], path: Optional[Path] = None) -> Path:
    """Commit the probes' sequences; refuses failed probes."""
    manifests.refuse_failed(actual)
    return manifests.write(MANIFEST_NAME, {
        "version": 1,
        "note": (
            "retrace budget of the PyTorch port: host-table uploads, per-device tables, "
            "kernel-library builds and custom ops after each probe step (see "
            "ringpop_tpu_torch/analysis/retrace.py).  Regenerate with '%s' after an "
            "intended change." % WRITE_HINT
        ),
        "probes": actual,
    }, path)


def check_against_manifest(probes: Optional[Iterable[Probe]] = None,
                           path: Optional[Path] = None) -> List[Finding]:
    try:
        manifest = manifests.load(MANIFEST_NAME, path)
    except FileNotFoundError:
        return [Finding(rule="retrace-budget", path=MANIFEST_NAME, line=0,
                        message="manifest missing — generate with %s" % WRITE_HINT,
                        prong=PRONG)]
    return compare_to_manifest(run_probes(probes), manifest)


# ---------------------------------------------------------------------------
# probes (named after JAX's where the port has the entry)


def _to(tree, device):
    """``tree``'s tensors on ``device`` (NamedTuples, tuples, lists)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _probe_farmhash(device):
    from ringpop_tpu_torch.ops import farmhash as fh

    def args(width, seed):
        rng = np.random.default_rng(seed)
        mat = torch.as_tensor(rng.integers(0, 256, size=(N, width)), dtype=torch.uint8)
        lens = torch.as_tensor(rng.integers(0, width - 4, size=(N,)), dtype=torch.int32)
        return _to((mat, lens), device)

    return fh.hash32_rows, [
        ("[8,64] values A", args(64, 0)),
        ("[8,64] values B (same shapes)", args(64, 1)),
        ("[8,128] wider rows", args(128, 2)),
    ]


def _probe_fused_checksum(device):
    from ringpop_tpu_torch.analysis import graph_audit as ga
    from ringpop_tpu_torch.ops import fused_checksum as fc

    universe = ga._universe()

    def fn(present, status, inc):
        return fc.membership_checksums(universe, present, status, inc)

    return fn, [
        ("B=2 values A", _to(ga._checksum_args(2, 0), device)),
        ("B=2 values B (same shapes)", _to(ga._checksum_args(2, 1), device)),
        ("B=4", _to(ga._checksum_args(4, 2), device)),
    ]


def _probe_ring_lookup(device):
    from ringpop_tpu_torch.models.ring import device as ringdev

    def fn(table, mask, keys):
        ring = ringdev.build_ring(table, mask)
        return ringdev.lookup(ring, ringdev.ring_size(mask, table.shape[1]), keys)

    def args(n, seed):
        rng = np.random.default_rng(seed)
        return _to((
            torch.as_tensor(rng.integers(-2**31, 2**31, size=(n, 100)), dtype=torch.int32),
            torch.as_tensor(rng.random(n) < 0.75),
            torch.as_tensor(rng.integers(-2**31, 2**31, 4), dtype=torch.int32),
        ), device)

    return fn, [("N=8 values A", args(8, 0)), ("N=8 values B (same shapes)", args(8, 1)),
                ("N=12 universe", args(12, 2))]


def _sim_probe(device, **kw):
    from ringpop_tpu_torch.models.sim import engine
    from ringpop_tpu_torch.models.sim.cluster import SimCluster

    sim = SimCluster(n=N, params=engine.SimParams(n=N, gate_phases=False, **kw), device=device,
                     seed=0)
    sim.bootstrap()
    params, universe = sim.params, sim.universe
    quiet = engine.TickInputs.quiet(N, device)
    kill = torch.zeros(N, dtype=torch.bool, device=device)
    kill[3] = True
    churn = quiet._replace(kill=kill)
    resumed = quiet._replace(resume=torch.zeros(N, dtype=torch.bool, device=device))
    state = sim.state

    def fn(state, inputs):
        return engine.tick(state, inputs, params, universe)

    return fn, [("n=8 quiet tick", (state, quiet)),
                ("n=8 churn tick, same structure", (state, churn)),
                ("n=8 resume plane present", (state, resumed))]


def _scalable_probe(device, **kw):
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    params = es.resolve_scalable_params(es.ScalableParams(n=N, u=128, **kw),
                                        torch.device(device).type)
    state = es.init_state(params, seed=0, device=device)
    quiet = es.ChurnInputs.quiet(N, device)
    kill = torch.zeros(N, dtype=torch.bool, device=device)
    kill[2] = True
    churn = quiet._replace(kill=kill)
    parted = quiet._replace(partition=torch.zeros(N, dtype=torch.int32, device=device))

    def fn(state, inputs):
        return es.tick(state, inputs, params)

    return fn, [("n=8 quiet tick", (state, quiet)),
                ("n=8 churn tick, same structure", (state, churn)),
                ("n=8 partition plane present", (state, parted))]


def _probe_exchange(device):
    from ringpop_tpu_torch.analysis import graph_audit as ga
    from ringpop_tpu_torch.ops import exchange as exch

    return exch.exchange, [
        ("[8,4] values A", _to(ga._exchange_args(8, 4, 0), device)),
        ("[8,4] values B (same shapes)", _to(ga._exchange_args(8, 4, 1), device)),
        ("[16,4] more rows", _to(ga._exchange_args(16, 4, 2), device)),
    ]


def _probe_exchange_plane(device):
    from ringpop_tpu_torch.analysis import graph_audit as ga

    fn, (per_shard,) = ga._entry_exchange_plane(device=device)
    _, (other,) = ga._entry_exchange_plane(device=device, seed=6)
    return fn, [("2 shards [4,4] values A", (per_shard,)),
                ("2 shards [4,4] values B (same shapes)", (other,)),
                ("2 shards [4,4] values A again", (per_shard,))]


def _probe_route_tick(device):
    from ringpop_tpu_torch.analysis import graph_audit as ga

    plane, params, buckets, reps, cdf, state, _ = ga._route_fixture("full")
    buckets, reps, cdf, state = _to((buckets, reps, cdf, state), device)

    def fn(state, in_ring, proc_alive, checksums):
        return plane.route_tick(state, buckets, reps, cdf, in_ring, proc_alive, checksums,
                                params)

    def nargs(seed):
        rng = np.random.default_rng(seed)
        return _to((torch.as_tensor(rng.random(N) < 0.8), torch.as_tensor(rng.random(N) < 0.9),
                    torch.as_tensor(rng.integers(-2**31, 2**31, N), dtype=torch.int32)), device)

    quiet = _to((torch.ones(N, dtype=torch.bool), torch.ones(N, dtype=torch.bool),
                 torch.zeros(N, dtype=torch.int32)), device)
    return fn, [("n=8 route tick", (state,) + nargs(1)),
                ("n=8 new values (same shapes)", (state,) + nargs(2)),
                ("n=8 every member in the ring", (state,) + quiet)]


def _probe_fuzz_scan(device):
    from ringpop_tpu_torch.fuzz import executor as fex
    from ringpop_tpu_torch.fuzz import scenarios as fsc
    from ringpop_tpu_torch.models.sim import batched
    from ringpop_tpu_torch.models.sim.cluster import _tick_at

    cfg = fsc.ScenarioConfig(engine="scalable", n=N, ticks=3)
    ex = fex.executor_for(cfg, device=device)

    def batch(b, seed0):
        states = batched.stack_states([ex._init_state(s) for s in range(seed0, seed0 + b)])
        inputs = fex._stack_inputs([fsc.generate(s, cfg).as_inputs(device)
                                    for s in range(seed0, seed0 + b)])
        return states, _tick_at(inputs, 0)

    def fn(states, inputs):
        return batched.vmap_tick(ex._tick, states, inputs, per_instance_inputs=True)

    return fn, [("B=2 scenario batch", batch(2, 0)), ("B=2 new values (same shapes)", batch(2, 7)),
                ("B=4 batch", batch(4, 0))]


DEFAULT_PROBES: List[Probe] = [
    Probe("farmhash", _probe_farmhash),
    Probe("fused-checksum", _probe_fused_checksum),
    Probe("ring-device-lookup", _probe_ring_lookup),
    Probe("engine-tick", lambda d: _sim_probe(d, fused_tick="off")),
    Probe("engine-tick-fused", lambda d: _sim_probe(d)),
    Probe("engine-scalable-tick", _scalable_probe, straight=False),
    Probe("exchange", _probe_exchange),
    Probe("exchange-plane", _probe_exchange_plane, straight=False),
    Probe("engine-scalable-tick-fused",
          lambda d: _scalable_probe(d, perm_impl="sortless"), straight=False),
    Probe("route-tick", _probe_route_tick),
    Probe("fuzz-scan", _probe_fuzz_scan, straight=False),
]

# JAX's probes -> the port probe standing for each
JAX_COUNTERPARTS: Dict[str, str] = {
    "farmhash-scan": "farmhash",
    "fused-checksum-xla": "fused-checksum",
    "ring-device-lookup": "ring-device-lookup",
    "engine-tick": "engine-tick",
    "engine-tick-fused": "engine-tick-fused",
    "engine-scalable-tick": "engine-scalable-tick",
    "exchange-xla": "exchange",
    "exchange-plane": "exchange-plane",
    "engine-scalable-tick-fused": "engine-scalable-tick-fused",
    "route-tick": "route-tick",
    "fuzz-scenario-scan": "fuzz-scan",
}
