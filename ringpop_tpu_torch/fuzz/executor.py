"""Batched scenario executor: B storms stepped together, one tick for all.

Counterpart of ``ringpop_tpu/fuzz/executor.py``.  One scenario instance is
tiny (n = 8-64): a single run leaves the card almost idle, and a fuzz
campaign wants thousands of them.  The executors here step B independent
instances — per-instance initial state AND per-instance fault schedule
(``in_dims=(0, 0)``, unlike ``models/sim/batched.py`` whose clusters share
one schedule) — through ``torch.func.vmap`` of the engine's tick over the
[T, B, ...] input planes, so every tick of a batch is one pass of the
tick's launches (each kernel launched once for all B instances by its
batching rule).

Full-fidelity instances run with the flight recorder ON: the per-instance
event buffers come back [B, cap, 8] and are decoded into per-instance
streams for the invariant layer (:mod:`ringpop_tpu_torch.fuzz.invariants`).
The scalable engine has no event plane; its invariants check final state
and per-tick metrics.  ``gate_phases`` is off, as in ``BatchedSimClusters``:
a batched predicate cannot be read on the host, and the two settings give
the same trajectory.

``shared_cache``: the JAX executors share compiled programs per
configuration, and mutation-gate tests that monkeypatch engine internals
construct them with ``shared_cache=False`` to keep broken traces out of
that cache.  The port compiles nothing — every tick calls the engine's
current functions — so the executors' constructors accept the switch and
ignore it, and callers of either package construct them unchanged.

Executors run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.fuzz import scenarios
from ringpop_tpu_torch.fuzz.scenarios import FULL, SCALABLE, ScenarioConfig
from ringpop_tpu_torch.models.sim import batched
from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim import flight
from ringpop_tpu_torch.models.sim.cluster import _tick_at, default_addresses, metrics_to_numpy
from ringpop_tpu_torch.ops import checksum_encode as ce


def event_capacity_for(n: int, ticks: int) -> int:
    """Per-instance event-buffer bound: the exact per-tick emission ceiling
    (``flight.max_events_per_tick``) times the window, rounded up to a
    power of two, so a fuzzed storm never truncates (the invariant layer
    treats drops as a violation)."""
    need = (ticks + 1) * flight.max_events_per_tick(n)
    cap = 1024
    while cap < need:
        cap *= 2
    return cap


def default_full_params(n: int, ticks: int, packet_loss: float = 0.0,
                        device=None) -> engine.SimParams:
    """Fuzz-campaign engine config: flight recorder on, "fast" checksum
    mode, short suspicion so suspect -> faulty -> refute cycles fit small
    windows; the knobs resolved for ``device`` as ``SimCluster`` resolves
    them, so an instance and a single-cluster replay of it share one
    params value."""
    params = engine.SimParams(
        n=n,
        checksum_mode="fast",
        suspicion_ticks=6,
        packet_loss=packet_loss,
        gate_phases=False,
        flight_recorder=True,
        event_capacity=event_capacity_for(n, ticks),
    )
    return batched.batched_params(params, resolve_device(device).type)


def default_scalable_params(
    n: int, packet_loss: float = 0.0, enable_leave: bool = True
) -> es.ScalableParams:
    digits = len(str(n))
    spt = es.SLOTS_PER_TICK + (1 if enable_leave else 0)
    need = spt * (15 * digits + 8 + 2)
    u = 128
    while u < need:
        u *= 2
    return es.ScalableParams(
        n=n,
        u=u,
        suspicion_ticks=6,
        packet_loss=packet_loss,
        enable_leave=enable_leave,
        gate_phases=False,
        perm_impl="sortless",
        fused_exchange="off",
    )


class FuzzRun(NamedTuple):
    """One batched pass: everything the invariant layer consumes."""

    engine: str
    params: Any  # SimParams | ScalableParams
    config: ScenarioConfig
    seeds: Tuple[int, ...]  # per-instance init/schedule seeds
    schedules: Tuple[Any, ...]  # per-instance schedule objects
    final_state: Any  # [B, ...]-stacked engine state (tensors on the device)
    metrics: Any  # [B, T]-stacked per-tick metrics (numpy)
    events: Optional[Tuple[Any, ...]]  # per-instance decoded streams (full)
    drops: Optional[Tuple[int, ...]]  # per-instance overflow counts


# obs-only planes per engine state class (the registries next to the
# state classes, as in the JAX executor)
_OBS_FIELDS = {
    "SimState": engine.SIM_OBS_ONLY_FIELDS,
    "ScalableState": es.SCALABLE_OBS_ONLY_FIELDS,
}


def split_obs(state):
    """Partition an engine state into (trajectory view, obs planes).

    The obs-plane names come from the field registries next to the state
    classes, so a renamed or added telemetry field breaks here instead of
    silently vanishing from the drained streams.  The trajectory view has
    the obs planes set to None."""
    obs_names = _OBS_FIELDS.get(type(state).__name__, frozenset())
    obs = {f: getattr(state, f) for f in obs_names if getattr(state, f) is not None}
    traj = state._replace(**{f: None for f in obs_names})
    return traj, obs


def _stack_inputs(inputs_list: Sequence[Any]) -> Any:
    """Per-instance [T, N] input tuples -> one [T, B, N] tuple.  Optional
    planes must agree (all None or none None), as the campaign's single
    blank-schedule shape guarantees."""
    first = inputs_list[0]
    return type(first)(*(
        None if getattr(first, f) is None
        else torch.stack([getattr(x, f) for x in inputs_list], dim=1)
        for f in first._fields
    ))


class _FuzzExecutorBase:
    """Shared run plumbing; subclasses bind the engine specifics."""

    engine_name: str = ""

    def __init__(self, config: ScenarioConfig, params, device):
        self.config = config
        self.params = params
        self.device = device

    # subclass hooks ----------------------------------------------------
    def _init_state(self, seed: int):
        raise NotImplementedError

    def _tick(self, state, inputs):
        raise NotImplementedError

    def _decode(self, final_state):
        return None, None

    # the run loop ------------------------------------------------------
    def run_seeds(self, seeds: Sequence[int]) -> FuzzRun:
        """Generate and run one schedule per seed (the seed also seeds the
        engine's init rng, so an instance is fully determined by it)."""
        scheds = [scenarios.generate(s, self.config) for s in seeds]
        return self.run_schedules(scheds, seeds)

    def run_schedules(
        self, schedules: Sequence[Any], seeds: Optional[Sequence[int]] = None
    ) -> FuzzRun:
        if seeds is None:
            seeds = [0] * len(schedules)
        if len(seeds) != len(schedules):
            raise ValueError("len(seeds) != len(schedules)")
        state = batched.stack_states([self._init_state(s) for s in seeds])
        inputs = _stack_inputs([s.as_inputs(self.device) for s in schedules])
        rows = []
        for t in range(schedules[0].ticks):
            state, m = batched.vmap_tick(self._tick, state, _tick_at(inputs, t),
                                         per_instance_inputs=True)
            rows.append(m)
        # instance-major [B, T], what the per-instance checks want
        metrics = metrics_to_numpy(type(rows[0])(*(
            torch.stack([getattr(m, f) for m in rows], dim=1) for f in rows[0]._fields
        )))
        events, drops = self._decode(state)
        return FuzzRun(
            engine=self.engine_name,
            params=self.params,
            config=self.config,
            seeds=tuple(int(s) for s in seeds),
            schedules=tuple(schedules),
            final_state=state,
            metrics=metrics,
            events=events,
            drops=drops,
        )


class FullFuzzExecutor(_FuzzExecutorBase):
    engine_name = FULL

    def __init__(
        self,
        config: ScenarioConfig,
        params: Optional[engine.SimParams] = None,
        packet_loss: float = 0.0,
        shared_cache: bool = True,
        device=None,
    ):
        dev = resolve_device(device)
        if params is None:
            params = default_full_params(config.n, config.ticks, packet_loss, dev)
        if not params.flight_recorder:
            raise ValueError(
                "the fuzz executor drains flight-recorder streams — "
                "construct params with flight_recorder=True"
            )
        self.universe = ce.Universe.from_addresses(default_addresses(config.n))
        super().__init__(config, batched.batched_params(params, dev.type), dev)

    def _init_state(self, seed: int):
        return engine.init_state(self.params, seed=int(seed), universe=self.universe,
                                 device=self.device)

    def _tick(self, state, inputs):
        return engine.tick(state, inputs, self.params, self.universe)

    def _decode(self, final_state):
        # drained planes named by the obs registry
        _, obs = split_obs(final_state)
        streams, drops = batched.decode_event_streams(
            obs["ev_buf"], obs["ev_head"], obs["ev_drops"]
        )
        return tuple(streams), tuple(drops)


class ScalableFuzzExecutor(_FuzzExecutorBase):
    engine_name = SCALABLE

    def __init__(
        self,
        config: ScenarioConfig,
        params: Optional[es.ScalableParams] = None,
        packet_loss: float = 0.0,
        shared_cache: bool = True,
        device=None,
    ):
        dev = resolve_device(device)
        if params is None:
            params = default_scalable_params(
                config.n, packet_loss, enable_leave=config.use_leave
            )
        super().__init__(config, es.resolve_scalable_params(params, dev.type), dev)

    def _init_state(self, seed: int):
        return es.init_state(self.params, seed=int(seed), device=self.device)

    def _tick(self, state, inputs):
        return es.tick(state, inputs, self.params)


def executor_for(
    config: ScenarioConfig,
    packet_loss: float = 0.0,
    device=None,
) -> _FuzzExecutorBase:
    cls = FullFuzzExecutor if config.engine == FULL else ScalableFuzzExecutor
    return cls(config, packet_loss=packet_loss, device=device)


def sweep(
    seeds: Sequence[int],
    config: ScenarioConfig,
    device=None,
) -> List[FuzzRun]:
    """Run every seed, bucketed by its packet-loss level so each level
    shares one executor; returns one FuzzRun per bucket.  Feed the runs to
    :func:`ringpop_tpu_torch.fuzz.invariants.check_run`."""
    buckets: dict = {}
    for s in seeds:
        buckets.setdefault(scenarios.packet_loss_of(s, config), []).append(s)
    runs: List[FuzzRun] = []
    for loss in sorted(buckets):
        ex = executor_for(config, packet_loss=loss, device=device)
        runs.append(ex.run_seeds(buckets[loss]))
    return runs
