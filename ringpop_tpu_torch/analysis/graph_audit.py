"""The ``graph`` prong: a recorded-op audit of the port's entry points.

Counterpart of ``ringpop_tpu/analysis/jaxpr_audit.py``.  Each registered
entry is run once at toy shapes (n=8) on the CPU under the
:class:`~ringpop_tpu_torch.analysis.dataflow.Recorder`, and the recording is
checked:

- ``host-sync``: the entry recorded more host reads (or uploads of a host
  table, a synchronous copy on the card) than it declares.  A
  straight-line tick, the batched tick, a kernel wrapper and a plain
  version declare none; a gated tick declares the reads its body yields to
  ``run_solo`` (``pred`` and ``counts``, counted by
  ``engine_scalable.host_read.count`` while it runs).  This is the torch
  form of JAX's ``callback-primitive``: what breaks the contract of a
  straight-line tick here is a host round trip, not a callback;
- ``wide-dtype-on-hash-path``: taint starts at the farmhash mixing
  constants and follows int32 (uint32) results; a float or 64-bit result
  of a hash-path value breaks the mod-2^32 arithmetic the bitwise claim
  rests on.  The widenings the port makes on purpose (a mod-2^32 row sum
  through int64, the unsigned shifts) are listed in
  :data:`HASH_WIDENING_ALLOWLIST` with a reason each, and an allowlist row
  no audited op matches is itself a finding;
- ``trace-failure``: an entry that fails to build or to run.

Each entry runs once before it is recorded, as the card audit runs its
paths: a per-device constant table uploads on first use, once a process.
Recordings are cached per process (:func:`clear_trace_cache`) and shared
with the noninterference, overflow, scale and cost prongs; those three
need the recorder's ``detail``, and a detailed recording (the same ops and
values, plus shapes, arguments and ranges) replaces a plain one.  :data:`JAX_ENTRY_COUNTERPARTS` maps each of
JAX's ``DEFAULT_ENTRIES`` to its port entry, or says why there is none.
The ``*-pallas`` entries become the wrapper entries (``*-kernel``): the
plain version on a CPU tensor, the CUDA kernel on a card's
(``chip_smoke.py`` records them there).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ringpop_tpu_torch.analysis import dataflow
from ringpop_tpu_torch.analysis.findings import Finding

PRONG = "graph"
N = 8

# Deliberate widenings of hash-path values: the innermost port frames of
# the widening op (``module.py:function``, callers after " < ") -> why the
# bits survive it.
HASH_WIDENING_ALLOWLIST: Dict[str, str] = {
    "ops/u32.py:to_u64 < models/sim/engine.py:shard_tick": (
        "the distinct-checksum count zero-extends each uint32 checksum to int64 "
        "so that the 0xFFFFFFFF sentinel of a non-participant sorts above every "
        "checksum; the low 32 bits are the checksum's, and only order and "
        "equality are read"
    ),
}

# Each JAX DEFAULT_ENTRIES name -> the port entry that stands for it, or
# the reason it has none (a string starting "none:").
JAX_ENTRY_COUNTERPARTS: Dict[str, str] = {
    "engine-tick-scan": "engine-tick",
    "engine-tick-scan-fused": "engine-tick-fused",
    "fused-apply-xla": "fused-apply-plain",
    "fused-apply-pallas": "fused-apply-kernel",
    "fused-piggyback-xla": "fused-piggyback-plain",
    "fused-piggyback-pallas": "fused-piggyback-kernel",
    "engine-tick-scan-flight-recorder": "engine-tick-flight-recorder",
    "engine-tick-scan-histograms": "engine-tick-histograms",
    "engine-scalable-tick": "engine-scalable-tick",
    "engine-scalable-tick-wavefront": "engine-scalable-tick-wavefront",
    "engine-scalable-tick-histograms": "engine-scalable-tick-histograms",
    "engine-scalable-tick-fused": "engine-scalable-tick-fused",
    "exchange-xla": "exchange-plain",
    "exchange-pallas": "exchange-kernel",
    "exchange-plane": "exchange-plane",
    "engine-scalable-tick-shardmap": "engine-scalable-tick-mesh",
    "exchange-plane-metrics": "exchange-plane-metrics",
    "engine-scalable-tick-shardmap-metrics": "engine-scalable-tick-mesh-metrics",
    "engine-scalable-tick-exchange-metrics": "engine-scalable-tick-exchange-metrics",
    "fused-checksum-xla": "fused-checksum-plain",
    "fused-checksum-pallas": "fused-checksum-kernel",
    "farmhash-scan": "farmhash-plain",
    "farmhash-pallas-nogrid": "farmhash-kernel",
    "ring-device-lookup": "ring-device-lookup",
    "route-tick-incremental": "route-tick-incremental",
    "route-tick-full": "route-tick-full",
    "route-tick-histograms": "route-tick-histograms",
    "route-tick-reqtrace": "route-tick-reqtrace",
    "route-ring-incremental": "route-ring-incremental",
    "fuzz-scenario-scan-full": "fuzz-scan-full",
    "fuzz-scenario-scan-scalable": "fuzz-scan-scalable",
    "exchange-local-xla": "exchange-local-plain",
    "route-lookup-batched": "route-lookup-batched",
    "checkpoint-restore": "checkpoint-restore",
}

YIELDED = "yielded"


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """``build() -> (fn, args)``; ``reads`` the host reads the entry
    declares: a count, or :data:`YIELDED` (those its body yields to
    ``run_solo``, counted while it runs)."""

    name: str
    build: Callable[[], Tuple[Callable, Tuple]]
    reads: Union[int, str] = 0


# ---------------------------------------------------------------------------
# fixtures (n=8, the CPU, seeded)


def _universe(n: int = N):
    from ringpop_tpu_torch.ops import checksum_encode as ce

    return ce.Universe.from_addresses([f"10.0.0.{i}:3000" for i in range(n)])


def _ticks(tick: Callable, t: int = 2) -> Callable:
    """``t`` ticks of ``tick(state, inputs_t)`` threaded through the state
    (the counterpart of JAX's ``lax.scan`` over a [T] input stack)."""

    def run(state, inputs):
        outs = []
        for i in range(t):
            state, m = tick(state, type(inputs)(*(None if x is None else x[i] for x in inputs)))
            outs.append(m)
        return state, outs

    return run


def _sim_inputs(n: int = N, t: int = 2, kill: bool = True):
    from ringpop_tpu_torch.models.sim import engine

    k = torch.zeros((t, n), dtype=torch.bool)
    if kill:
        k[0, n - 1] = True  # one kill, so the gated phases run
    return engine.TickInputs(
        kill=k,
        revive=torch.zeros((t, n), dtype=torch.bool),
        join=torch.zeros((t, n), dtype=torch.bool),
        partition=torch.full((t, n), -1, dtype=torch.int32),
    )


def _booted_sim(params):
    """A bootstrapped n=8 cluster's state (every node joined)."""
    from ringpop_tpu_torch.models.sim import cluster

    sim = cluster.SimCluster(n=params.n, params=params, device="cpu", seed=0)
    sim.bootstrap()
    return sim.state, sim.params, sim.universe


def _entry_engine_tick(checksum_mode: str = "farmhash", fused_tick: str = "off",
                       gate_phases: bool = True, **planes):
    from ringpop_tpu_torch.models.sim import engine

    params = engine.SimParams(n=N, checksum_mode=checksum_mode, fused_tick=fused_tick,
                              hash_impl="plain", gate_phases=gate_phases,
                              event_capacity=256, **planes)
    state, params, universe = _booted_sim(params)
    return _ticks(lambda s, i: engine.tick(s, i, params, universe)), (state, _sim_inputs())


def _entry_batched_tick(checksum_mode: str = "farmhash"):
    from ringpop_tpu_torch.models.sim import batched, engine

    bat = batched.BatchedSimClusters(2, N, engine.SimParams(n=N, checksum_mode=checksum_mode),
                                     device="cpu")
    bat.bootstrap()
    return _ticks(bat._tick), (bat.state, _sim_inputs())


def _rng(seed: int):
    return np.random.default_rng(seed)


def _apply_args(n: int = N, seed: int = 0):
    from ringpop_tpu_torch.ops import fused_apply as fap
    from ringpop_tpu_torch.ops import toolkit

    rng = _rng(seed)

    def bpl(p):
        return torch.as_tensor(rng.random((n, n)) < p)

    def ipl(lo, hi):
        return torch.as_tensor(rng.integers(lo, hi, (n, n)), dtype=torch.int32)

    st = fap.ApplyState(bpl(0.8), ipl(0, 4), ipl(0, 20), bpl(0.3), ipl(0, 4),
                        ipl(0, 20), ipl(-1, n), ipl(0, 20), ipl(0, 9), ipl(-1, 30))
    union = torch.zeros((n, toolkit.packed_width(n)), dtype=torch.int32)
    return st, bpl(0.4), ipl(0, 4), ipl(0, 20), ipl(0, n), ipl(0, 20), union


def _entry_fused_apply(impl: str):
    from ringpop_tpu_torch.ops import fused_apply as fap

    fn = fap.apply_updates if impl == "kernel" else fap.apply_updates_plain

    def op(st, recv, us, ui, usrc, usi, union, now, deadline):
        return fn(st, recv, us, ui, usrc, usi, now, deadline, union, want_masks=True,
                  want_count=True)

    # the stamps are device tensors, as the tick passes them
    stamps = (torch.tensor(5, dtype=torch.int32), torch.tensor(9, dtype=torch.int32))
    return op, _apply_args() + stamps


def _entry_fused_piggyback(impl: str):
    from ringpop_tpu_torch.ops import fused_piggyback as fpb

    fn = fpb.pb_budget if impl == "kernel" else fpb.pb_budget_plain
    rng = _rng(2)
    args = (
        torch.as_tensor(rng.random((N, N)) < 0.5),
        torch.as_tensor(rng.integers(0, 9, (N, N)), dtype=torch.int32),
        torch.as_tensor(rng.integers(0, 3, N), dtype=torch.int32),
        torch.as_tensor(rng.integers(4, 16, N), dtype=torch.int32),
        torch.as_tensor(rng.integers(0, 2, (N, N)), dtype=torch.int32),
    )
    return (lambda *a: fn(*a)), args


def _checksum_args(b: int = 4, seed: int = 0):
    rng = _rng(seed)
    present = torch.as_tensor(rng.random((b, N)) < 0.8)
    status = torch.as_tensor(rng.integers(0, 4, size=(b, N)), dtype=torch.int32)
    inc = torch.as_tensor(rng.integers(1, 2**31 - 1, size=(b, N)), dtype=torch.int64)
    return present, status, inc


def _entry_fused_checksum(impl: str):
    from ringpop_tpu_torch.ops import fused_checksum as fc

    universe = _universe()

    def fused(present, status, inc):
        return fc.membership_checksums(universe, present, status, inc, impl=impl)

    return fused, _checksum_args()


def _stream_args():
    from ringpop_tpu_torch.ops import fused_checksum as fc

    present, status, inc = _checksum_args()
    rec_b, rec_l = fc.member_records(_universe(), present, status, inc)
    words = fc.pack_record_words(rec_b)
    b = present.shape[0]
    rng = _rng(4)

    def carry():
        return torch.as_tensor(rng.integers(-2**31, 2**31, b), dtype=torch.int32)

    total = (rec_l.sum(dim=1, dtype=torch.int32) - 1).clamp(min=0) // 20
    return carry(), carry(), carry(), words, rec_l, total


def _entry_fused_stream(impl: str):
    from ringpop_tpu_torch.ops import stream_hash as sh

    fn = sh.fused_stream if impl == "kernel" else sh.fused_stream_plain
    return (lambda *a: fn(*a)), _stream_args()


def _farmhash_args(b: int = 8, width: int = 64):
    rng = _rng(1)
    mat = torch.as_tensor(rng.integers(0, 256, size=(b, width)), dtype=torch.uint8)
    lens = torch.as_tensor(rng.integers(0, width - 4, size=(b,)), dtype=torch.int32)
    return mat, lens


def _entry_farmhash(impl: str):
    from ringpop_tpu_torch.ops import farmhash as fh

    def hash_rows(mat, lens):
        return fh.hash32_rows(mat, lens, impl=impl)

    return hash_rows, _farmhash_args()


def _block_args(b: int = 8, n_iter: int = 4):
    rng = _rng(3)

    def words(shape):
        return torch.as_tensor(rng.integers(-2**31, 2**31, shape), dtype=torch.int32)

    iters = torch.as_tensor(rng.integers(0, n_iter + 1, b), dtype=torch.int32)
    return words(b), words(b), words(b), words((b, n_iter, 5)), iters


def _entry_block_loop(impl: str):
    from ringpop_tpu_torch.ops import block_loop as bl

    fn = bl.block_loop if impl == "kernel" else bl.block_loop_plain
    return (lambda *a: fn(*a)), _block_args()


def _exchange_args(n: int = N, w: int = 4, seed: int = 3):
    rng = _rng(seed)

    def u32(shape):
        return torch.as_tensor(rng.integers(-2**31, 2**31, size=shape), dtype=torch.int32)

    return u32((n, w)), u32((n, w)), u32((n, w)), u32((w * 32,))


def _entry_exchange(impl: str):
    from ringpop_tpu_torch.ops import exchange as exch

    if impl == "local":
        def fn(h, pl, ps, d):
            return exch.exchange_local(h, pl, ps, d, impl="plain")
    elif impl == "kernel":
        fn = exch.exchange
    else:
        fn = exch.exchange_plain
    return (lambda *a: fn(*a)), _exchange_args()


def _scalable_params(**kw):
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    return es.resolve_scalable_params(es.ScalableParams(n=N, u=128, **kw), "cpu")


def _scalable_inputs(t: int = 2):
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    k = torch.zeros((t, N), dtype=torch.bool)
    k[0, N - 1] = True
    return es.ChurnInputs(kill=k, revive=torch.zeros((t, N), dtype=torch.bool))


def _entry_scalable_tick(**kw):
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    params = _scalable_params(**kw)
    state = es.init_state(params, seed=0, device="cpu")
    return _ticks(lambda s, i: es.tick(s, i, params)), (state, _scalable_inputs())


def _mesh(shards: int = 2, device="cpu"):
    from ringpop_tpu_torch.parallel import mesh as pmesh

    return pmesh.make_mesh(shards, device=device)


def _entry_exchange_plane(metrics: bool = False, device="cpu", seed: int = 5):
    """The mesh's direct-round plane on a 2-shard mesh (of the CPU here;
    the retrace prong's probe also runs it on a card): the capped
    all-to-all row routes and ``exchange_local`` on each shard's tile."""
    from ringpop_tpu_torch.ops import exchange as exch
    from ringpop_tpu_torch.parallel import comm, mesh as pmesh

    m = _mesh(device=device)
    plane = pmesh.make_exchange_plane(m, "plain", n=N, metrics=metrics)
    rows = N // m.size
    shards = [pmesh.Shard(s, m.size, rows, pmesh.exchange_cap(rows, m.size), metrics)
              for s in range(m.size)]
    rng = _rng(seed)
    heard, _, _, r_delta = _exchange_args()
    w = heard.shape[1]
    active = torch.as_tensor(rng.integers(-2**31, 2**31, w), dtype=torch.int32)
    ok = torch.as_tensor(rng.random(N) < 0.7)
    perm = rng.permutation(N)
    fwd = torch.as_tensor(perm, dtype=torch.int32)
    inv = torch.as_tensor(np.argsort(perm), dtype=torch.int32)
    per_shard = []
    for sh in shards:
        cut = slice(sh.lo, sh.lo + rows)
        args = [heard[cut], r_delta, active, ok[cut], fwd[cut], inv[cut]]
        if metrics:
            args += [exch.init_exchange_counters(1), exch.init_exchange_hist(1)]
        per_shard.append(tuple(a.to(device) for a in args))
    mc = comm.MeshComm(m.devices)

    def fn(per_shard):
        return comm.lockstep([plane(sh, *a) for sh, a in zip(shards, per_shard)], mc)

    return fn, (per_shard,)


def _entry_scalable_mesh(metrics: bool = False):
    """The storm tick as ``ShardedStorm`` runs it on a 2-shard CPU mesh:
    two ``shard_tick`` bodies in lockstep, the direct round on the
    exchange plane."""
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.parallel import comm, mesh as pmesh

    params = es.ScalableParams(n=N, u=128, perm_impl="sortless", fused_exchange="kernel",
                               exchange_metrics=2 if metrics else 0)
    storm = pmesh.ShardedStorm(N, mesh=_mesh(), params=params, seed=0)
    shards, plane, mc, p = storm._shards, storm._plane, storm.comm, storm.params
    inputs = _scalable_inputs()

    def one(states, inputs):
        out = []
        for i in range(inputs.kill.shape[0]):
            ins = [es.ChurnInputs(kill=inputs.kill[i, sh.lo:sh.lo + sh.rows],
                                  revive=inputs.revive[i, sh.lo:sh.lo + sh.rows])
                   for sh in shards]
            res = comm.lockstep([es.shard_tick(sh, st, inp, p, plane)
                                 for sh, st, inp in zip(shards, states, ins)], mc)
            states = [st for st, _ in res]
            out.append(res[0][1])
        return states, out

    return one, (list(storm.shard_states), inputs)


def _entry_ring_device():
    from ringpop_tpu_torch.models.ring import device

    rng = _rng(2)
    table = torch.as_tensor(rng.integers(-2**31, 2**31, size=(N, 100)), dtype=torch.int32)
    mask = torch.as_tensor(rng.random(N) < 0.75)
    keys = torch.as_tensor(rng.integers(-2**31, 2**31, 4), dtype=torch.int32)

    def ring_lookup(table, mask, keys):
        ring = device.build_ring(table, mask)
        n_points = device.ring_size(mask, table.shape[1])
        return device.lookup(ring, n_points, keys), device.lookup_n(ring, n_points,
                                                                     keys[0], 3)

    return ring_lookup, (table, mask, keys)


def _route_fixture(impl: str, histograms: bool = False, reqtrace: bool = False):
    from ringpop_tpu_torch.models.ring import device as ringdev
    from ringpop_tpu_torch.models.route import plane, ring_kernel, traffic

    params = plane.RouteParams(
        n=N, replica_points=4, bucket_bits=2, queries_per_tick=16, key_space=64,
        ring_impl=impl, max_changed=4, max_dirty=4, histograms=histograms,
        reqtrace=reqtrace, req_capacity=64, req_sample_log2=1,
    )
    reps = ringdev.device_replica_hashes(N, 4)
    buckets = ring_kernel.build_buckets(reps, params.bucket_bits)
    cdf = traffic.zipf_cdf(params.key_space, params.zipf_s)
    rng = _rng(4)
    state = plane.init_route_state(params, buckets, reps, torch.as_tensor(rng.random(N) < 0.9),
                                   seed=4)
    dyn = (
        torch.as_tensor(rng.random(N) < 0.8),
        torch.as_tensor(rng.random(N) < 0.9),
        torch.as_tensor(rng.integers(-2**31, 2**31, N), dtype=torch.int32),
    )
    return plane, params, buckets, reps, cdf, state, dyn


def _entry_route_tick(impl: str, histograms: bool = False, reqtrace: bool = False):
    plane, params, buckets, reps, cdf, state, dyn = _route_fixture(impl, histograms, reqtrace)

    def one(state, in_ring, proc_alive, checksums):
        return plane.route_tick(state, buckets, reps, cdf, in_ring, proc_alive, checksums,
                                params)

    return one, (state,) + dyn


def _entry_route_ring_incremental():
    from ringpop_tpu_torch.models.route import ring_kernel as rk

    plane, params, buckets, reps, cdf, state, dyn = _route_fixture("incremental")
    keys = torch.as_tensor(_rng(6).integers(-2**31, 2**31, 16), dtype=torch.int32)

    def one(rstate, in_ring, keys):
        st, n_changed, n_dirty, ov = rk.update(buckets, rstate, in_ring, max_changed=4,
                                               max_dirty=4)
        return rk.lookup(st, keys), rk.materialize(st, N * 4), n_changed

    return one, (state.ring, dyn[0], keys)


def _entry_route_lookup_batched():
    from ringpop_tpu_torch.models.ring import device
    from ringpop_tpu_torch.models.route import ring_kernel

    table, mask, _ = _entry_ring_device()[1]
    keys = torch.as_tensor(_rng(5).integers(-2**31, 2**31, 16), dtype=torch.int32)

    def batched(table, mask, keys):
        # the port's lookup_n_fixed takes the [Q] batch itself (JAX vmaps it)
        ring = device.build_ring(table, mask)
        n_points = device.ring_size(mask, table.shape[1])
        return ring_kernel.lookup_n_fixed(ring, n_points, keys, 3, 6)

    return batched, (table, mask, keys)


def _entry_fuzz(engine_name: str, b: int = 2, t: int = 2):
    from ringpop_tpu_torch.fuzz import executor as fex
    from ringpop_tpu_torch.fuzz import scenarios as fsc
    from ringpop_tpu_torch.models.sim import batched
    from ringpop_tpu_torch.models.sim.cluster import _tick_at

    cfg = fsc.ScenarioConfig(engine=engine_name, n=N, ticks=3)
    ex = fex.executor_for(cfg, device="cpu")
    states = batched.stack_states([ex._init_state(s) for s in range(b)])
    inputs = fex._stack_inputs([fsc.generate(s, cfg).as_inputs("cpu") for s in range(b)])

    def scan(states, inputs):
        out = []
        for i in range(t):
            states, m = batched.vmap_tick(ex._tick, states, _tick_at(inputs, i),
                                          per_instance_inputs=True)
            out.append(m)
        return states, out

    return scan, (states, inputs)


def _entry_checkpoint_restore():
    from ringpop_tpu_torch.models.sim import cluster, engine

    params = engine.SimParams(n=N, hash_impl="plain", fused_checksum="on")
    universe = _universe()
    state = engine.init_state(params, seed=0, universe=universe, device="cpu")

    def restore(state):
        return cluster.fixup_sim_state(state, params, universe)

    return restore, (state,)


DEFAULT_ENTRIES: List[EntryPoint] = [
    # the full engine: gated (the reads its body yields) and straight-line
    EntryPoint("engine-tick", lambda: _entry_engine_tick(), YIELDED),
    EntryPoint("engine-tick-fused", lambda: _entry_engine_tick(fused_tick="plain"), YIELDED),
    EntryPoint("engine-tick-flight-recorder",
               lambda: _entry_engine_tick(flight_recorder=True), YIELDED),
    EntryPoint("engine-tick-histograms", lambda: _entry_engine_tick(histograms=True), YIELDED),
    EntryPoint("engine-tick-straight",
               lambda: _entry_engine_tick(fused_tick="plain", gate_phases=False), 0),
    EntryPoint("engine-tick-straight-fast",
               lambda: _entry_engine_tick("fast", fused_tick="plain", gate_phases=False), 0),
    EntryPoint("batched-tick", lambda: _entry_batched_tick(), 0),
    # the kernel wrappers (the CUDA kernels on a card) and plain versions
    EntryPoint("fused-apply-plain", lambda: _entry_fused_apply("plain"), 0),
    EntryPoint("fused-apply-kernel", lambda: _entry_fused_apply("kernel"), 0),
    EntryPoint("fused-piggyback-plain", lambda: _entry_fused_piggyback("plain"), 0),
    EntryPoint("fused-piggyback-kernel", lambda: _entry_fused_piggyback("kernel"), 0),
    EntryPoint("fused-stream-plain", lambda: _entry_fused_stream("plain"), 0),
    EntryPoint("fused-stream-kernel", lambda: _entry_fused_stream("kernel"), 0),
    EntryPoint("block-loop-plain", lambda: _entry_block_loop("plain"), 0),
    EntryPoint("block-loop-kernel", lambda: _entry_block_loop("kernel"), 0),
    EntryPoint("exchange-plain", lambda: _entry_exchange("plain"), 0),
    EntryPoint("exchange-kernel", lambda: _entry_exchange("kernel"), 0),
    EntryPoint("exchange-local-plain", lambda: _entry_exchange("local"), 0),
    EntryPoint("fused-checksum-plain", lambda: _entry_fused_checksum("plain"), 0),
    EntryPoint("fused-checksum-kernel", lambda: _entry_fused_checksum("kernel"), 0),
    EntryPoint("farmhash-plain", lambda: _entry_farmhash("plain"), 0),
    EntryPoint("farmhash-kernel", lambda: _entry_farmhash("kernel"), 0),
    # the scalable engine and the mesh (the storm reads its gated phases
    # and PRP walks on the host: what the body yields or host_read counts)
    EntryPoint("engine-scalable-tick", lambda: _entry_scalable_tick(), YIELDED),
    EntryPoint("engine-scalable-tick-wavefront",
               lambda: _entry_scalable_tick(wavefront=True), YIELDED),
    EntryPoint("engine-scalable-tick-histograms",
               lambda: _entry_scalable_tick(histograms=True), YIELDED),
    EntryPoint("engine-scalable-tick-fused",
               lambda: _entry_scalable_tick(perm_impl="sortless", fused_exchange="plain"),
               YIELDED),
    EntryPoint("engine-scalable-tick-exchange-metrics",
               lambda: _entry_scalable_tick(perm_impl="sortless", fused_exchange="plain",
                                            exchange_metrics=4), YIELDED),
    # the plane's overflow fallback is an agreed predicate (a collective)
    EntryPoint("exchange-plane", lambda: _entry_exchange_plane(), YIELDED),
    EntryPoint("exchange-plane-metrics", lambda: _entry_exchange_plane(metrics=True), YIELDED),
    EntryPoint("engine-scalable-tick-mesh", lambda: _entry_scalable_mesh(), YIELDED),
    EntryPoint("engine-scalable-tick-mesh-metrics", lambda: _entry_scalable_mesh(metrics=True),
               YIELDED),
    # the ring and the routing plane (the incremental ring update reads
    # its overflow flag on the host once, through host_read)
    # device.lookup_n walks successors on the host (it reads the ring size
    # and the first successor, and uploads the owners found): a host API
    # outside every tick
    EntryPoint("ring-device-lookup", _entry_ring_device, 3),
    EntryPoint("route-tick-incremental", lambda: _entry_route_tick("incremental"), YIELDED),
    EntryPoint("route-tick-full", lambda: _entry_route_tick("full"), 0),
    EntryPoint("route-tick-histograms",
               lambda: _entry_route_tick("incremental", histograms=True), YIELDED),
    EntryPoint("route-tick-reqtrace", lambda: _entry_route_tick("incremental", reqtrace=True),
               YIELDED),
    EntryPoint("route-ring-incremental", _entry_route_ring_incremental, YIELDED),
    EntryPoint("route-lookup-batched", _entry_route_lookup_batched, 0),
    # the fuzz executors' batched ticks and the restore fixup
    EntryPoint("fuzz-scan-full", lambda: _entry_fuzz("full"), 0),
    EntryPoint("fuzz-scan-scalable", lambda: _entry_fuzz("scalable"), YIELDED),
    EntryPoint("checkpoint-restore", _entry_checkpoint_restore, 0),
]

ENTRIES_BY_NAME: Dict[str, EntryPoint] = {ep.name: ep for ep in DEFAULT_ENTRIES}


# ---------------------------------------------------------------------------
# recording and the rules


@dataclasses.dataclass
class Recorded:
    """A registered entry's recording plus the host reads it declares."""

    recording: dataflow.Recording
    declared: int
    args: Tuple


_TRACE_CACHE: Dict[str, Recorded] = {}
_ALLOWLIST_HITS: set = set()


def clear_trace_cache() -> None:
    _TRACE_CACHE.clear()
    _ALLOWLIST_HITS.clear()


def _allowed(stack: Tuple[str, ...]) -> bool:
    for key in HASH_WIDENING_ALLOWLIST:
        frames = tuple(key.split(" < "))
        if stack[:len(frames)] == frames:
            _ALLOWLIST_HITS.add(key)
            return True
    return False


def record_entry(name: str, fn: Callable, args: Tuple, reads: Union[int, str] = 0,
                 detail: bool = False) -> Recorded:
    """Record ``fn(*args)`` (hash taint on) and the reads it declares
    (``detail``: the recorder's shapes, arguments and ranges too)."""
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    fn(*args)  # warm: per-device constant tables upload on first use
    before = es.host_read.count
    rec = dataflow.record(fn, args, hash_taint=True, allowed=_allowed, detail=detail)
    declared = es.host_read.count - before if reads == YIELDED else int(reads)
    return Recorded(rec, declared, args)


def recorded(ep: EntryPoint, detail: bool = False) -> Recorded:
    """A registered entry's recording, made once per process.  A detailed
    recording serves every prong (its ops and value ids are the plain
    one's), so a prong that needs the detail replaces a plain one."""
    hit = _TRACE_CACHE.get(ep.name)
    if hit is None or (detail and not hit.recording.detail):
        fn, args = ep.build()
        hit = record_entry(ep.name, fn, args, ep.reads, detail=detail)
        _TRACE_CACHE[ep.name] = hit
    return hit


def _finding(rule: str, name: str, message: str) -> Finding:
    return Finding(rule=rule, path=f"<entry:{name}>", line=0, message=message, prong=PRONG)


def trace_failure(name: str, e: Exception, prong: str = PRONG) -> Finding:
    return Finding(rule="trace-failure", path=f"<entry:{name}>", line=0,
                   message=f"entry point failed to run: {type(e).__name__}: {e}", prong=prong)


def audit_recorded(name: str, r: Recorded) -> List[Finding]:
    findings = []
    reads = r.recording.host_reads
    if len(reads) > r.declared:
        where = sorted({f"{op.name.split('::')[-1]}@{op.loc or '<top>'}" for op in reads})
        findings.append(_finding(
            "host-sync", name,
            f"{len(reads)} host read(s) recorded, {r.declared} declared: "
            + ", ".join(where[:6])))
    seen = set()
    for op in r.recording.hash_findings:
        key = (op.name, op.loc)
        if key in seen:
            continue
        seen.add(key)
        findings.append(_finding(
            "wide-dtype-on-hash-path", name,
            f"'{op.name.split('::')[-1]}' at {op.loc or '<top>'} gives "
            f"{'/'.join(sorted(set(op.out_dtypes)))} from the int32 hash path — a widening "
            f"breaks mod-2^32 parity (stack: {' < '.join(op.stack[:4])})"))
    return findings


def audit_fn(name: str, fn: Callable, args: Tuple, reads: Union[int, str] = 0) -> List[Finding]:
    """Record ``fn(*args)`` (uncached) and audit it."""
    try:
        r = record_entry(name, fn, args, reads)
    except Exception as e:  # a broken entry point is itself a finding
        return [trace_failure(name, e)]
    return audit_recorded(name, r)


def audit_entries(entries: Optional[Iterable[EntryPoint]] = None) -> List[Finding]:
    """The prong: audit the registered entries (or ``entries``).  A run
    over the whole registry also reports allowlist rows nothing matched."""
    registry = entries is None
    out: List[Finding] = []
    for ep in DEFAULT_ENTRIES if registry else entries:
        try:
            r = recorded(ep) if registry else record_entry(ep.name, *ep.build(), ep.reads)
        except Exception as e:
            out.append(trace_failure(ep.name, e))
            continue
        out.extend(audit_recorded(ep.name, r))
    if registry:
        for key in sorted(set(HASH_WIDENING_ALLOWLIST) - _ALLOWLIST_HITS):
            out.append(_finding(
                "wide-dtype-on-hash-path", "allowlist",
                f"HASH_WIDENING_ALLOWLIST row {key!r} matches no recorded op: drop it"))
    return out
