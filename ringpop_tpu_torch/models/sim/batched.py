"""BatchedSimClusters — B independent full-fidelity clusters, one tick.

Counterpart of ``ringpop_tpu/models/sim/batched.py``.  A single cluster at
tick-cluster scale (n ~ 1k) leaves the card mostly idle: the tick issues
hundreds of small launches (PERF.md §5).  Batching B clusters on a leading
axis turns every ``[N, N]`` op into a ``[B, N, N]`` op at the same launch
count, while each cluster's trajectory stays exactly the single-cluster
trajectory for its seed (tests/test_torch_batched.py holds it, and the
batched run against the JAX module's).

The tick is ``torch.func.vmap(tick, in_dims=(0, None))`` over the state's
tensor fields (:func:`vmap_tick`; fields that are None ride outside the
map).  Under vmap every CUDA kernel wrapper routes its batched operands
through its custom op, whose batching rule launches the kernel once for
all B clusters, and a batched tensor cannot be read on the host, so the
tick runs straight-line: ``gate_phases=False`` (bitwise the gated
trajectory), and the farmhash recompute in its "full" shape where the
cluster would pick "bounded" (no per-cluster overflow replay here, as in
the JAX module) or "gated" (a host read of the dirty count; the JAX
engine's vmapped dirty-chunk loop computes the same checksums).

Runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim.cluster import (
    EventSchedule, _tick_at, default_addresses, metrics_to_numpy,
)
from ringpop_tpu_torch.obs import events as obs_events
from ringpop_tpu_torch.obs import perf
from ringpop_tpu_torch.ops import checksum_encode as ce
from ringpop_tpu_torch.ops import u32


def stack_states(states):
    """B engine states (one NamedTuple type) -> one with a leading [B] axis
    on every tensor field; None fields stay None."""
    first = states[0]
    return type(first)(*(
        None if getattr(first, f) is None else torch.stack([getattr(s, f) for s in states])
        for f in first._fields
    ))


def vmap_tick(step: Callable, state, inputs, per_instance_inputs: bool = False):
    """One tick of ``step(state, inputs) -> (state, metrics)`` for B
    stacked states under ``torch.func.vmap``.  ``inputs`` are shared by
    every instance (``in_dims=None``) or, with ``per_instance_inputs``,
    carry their own leading [B] axis.  Returns the stacked state and a
    metrics tuple of [B] tensors."""
    present = tuple(f for f in state._fields if getattr(state, f) is not None)
    absent = {f: None for f in state._fields if getattr(state, f) is None}
    metrics_type = []

    def body(tensors, inp):
        new, metrics = step(type(state)(**absent, **dict(zip(present, tensors))), inp)
        metrics_type.append(type(metrics))
        return tuple(getattr(new, f) for f in present), tuple(metrics)

    dim = 0 if per_instance_inputs else None
    in_inputs = type(inputs)(*(None if x is None else dim for x in inputs))
    tensors, metrics = torch.func.vmap(body, in_dims=(0, in_inputs))(
        tuple(getattr(state, f) for f in present), inputs
    )
    return state._replace(**dict(zip(present, tensors))), metrics_type[0](*metrics)


def decode_event_streams(ev_buf, ev_head, ev_drops):
    """B stacked flight-recorder planes -> (B decoded event streams, B drop
    counts); only each buffer's valid rows cross to the host."""
    heads = ev_head.to("cpu").numpy()
    drops = ev_drops.to("cpu").numpy()
    bufs = ev_buf[:, : int(heads.max(initial=0))].to("cpu").numpy()
    streams = [obs_events.decode_events(bufs[i], heads[i], drops[i]) for i in range(len(heads))]
    return streams, [int(d) for d in drops]


def batched_params(params: engine.SimParams, device_type: str) -> engine.SimParams:
    """The full engine's knobs for a batched tick on ``device_type``:
    resolved as ``SimCluster`` resolves them, straight-line
    (``gate_phases=False``), and the farmhash recompute in its "full"
    shape where the cluster would pick "bounded" or "gated"."""
    params = params._replace(gate_phases=False)
    params = params._replace(hash_impl=engine.resolve_hash_impl(params, device_type))
    params = engine.resolve_auto_parity(params, device_type)
    if params.checksum_mode == "farmhash" and params.parity_recompute in ("bounded", "gated"):
        params = params._replace(parity_recompute="full")
    return params


def clear_executable_cache() -> None:
    """The JAX module's cache of compiled batched ticks.  PyTorch runs the
    tick eagerly, so there is nothing compiled to drop; kept so callers of
    either package can reset between configurations."""


class BatchedSimClusters:
    """B clusters of n nodes, seeds ``seed .. seed + B - 1``, stepped
    together through one shared event schedule."""

    def __init__(
        self,
        b: int,
        n: int,
        params: Optional[engine.SimParams] = None,
        seed: int = 0,
        device=None,
    ):
        self.b, self.n = b, n
        self.device = resolve_device(device)
        self.universe = ce.Universe.from_addresses(default_addresses(n))
        base = params or engine.SimParams(n=n, checksum_mode="fast")
        self.params = batched_params(base._replace(n=n), self.device.type)
        self.state = stack_states([
            engine.init_state(self.params, seed=seed + i, universe=self.universe,
                              device=self.device)
            for i in range(b)
        ])
        # optional telemetry sink (obs.recorder.RunRecorder via attach_recorder)
        self.recorder = None

    def _tick(self, state, inputs):
        with perf.span("batched.tick"):
            return vmap_tick(
                lambda s, i: engine.tick(s, i, self.params, self.universe), state, inputs
            )

    def attach_recorder(self, recorder) -> None:
        """Attach an ``obs.recorder.RunRecorder``; bootstrap()/run() metrics
        fold into it.  Rows carry per-cluster [B] vectors per counter;
        totals fold only the scalar fields."""
        recorder.describe("sim.engine[batched]", self.n, self.params, b=self.b)
        self.recorder = recorder

    def bootstrap(self) -> engine.TickMetrics:
        """Join every node of every cluster at once; metrics are [B]."""
        inputs = engine.TickInputs.quiet(self.n, self.device)._replace(
            join=torch.ones(self.n, dtype=torch.bool, device=self.device)
        )
        self.state, m = self._tick(self.state, inputs)
        with perf.span("batched.metrics_read"):
            m = metrics_to_numpy(m)
        if self.recorder is not None:
            self.recorder.record_ticks(type(m)(*(a[None] for a in m)))
        return m

    def run(self, schedule: EventSchedule) -> engine.TickMetrics:
        """Step the same [T, N] event schedule through every cluster;
        metrics come back [T, B]-shaped (numpy).  The span log's
        ``rows_dirty`` counts their ``dirty_rows``."""
        with perf.span("batched.run"):
            inputs = schedule.as_inputs(self.device)
            rows = []
            state = self.state
            for t in range(schedule.ticks):
                state, m = self._tick(state, _tick_at(inputs, t))
                rows.append(m)
            self.state = state
            with perf.span("batched.metrics_read"):
                ms = metrics_to_numpy(engine.TickMetrics(
                    *(torch.stack([getattr(m, f) for m in rows])
                      for f in engine.TickMetrics._fields)
                ))
        if perf.active() is not None:
            perf.count("rows_dirty", int(ms.dirty_rows.sum(dtype=np.int64)))
        if self.recorder is not None:
            self.recorder.record_ticks(ms)
        return ms

    def checksums(self) -> np.ndarray:
        """[B, N] uint32 per-cluster membership checksums."""
        return u32.to_numpy(self.state.checksum)

    # -- flight recorder (SimParams.flight_recorder) ----------------------

    def drain_events(self, reset: bool = True) -> List[List[dict]]:
        """Per-cluster flight-recorder drain: a list of B decoded event
        streams.  Feeds the attached recorder one ``flight_drain`` row with
        per-cluster counts, then (``reset``) clears every cluster's head
        and drop counter — last, so a raising sink leaves the window on the
        device for a retry."""
        if self.state.ev_buf is None:
            raise ValueError(
                "flight recorder is off — construct with SimParams(flight_recorder=True)"
            )
        streams, drops = decode_event_streams(
            self.state.ev_buf, self.state.ev_head, self.state.ev_drops
        )
        if self.recorder is not None:
            self.recorder.record_event(
                "flight_drain", events=[len(s) for s in streams], drops=drops
            )
        if reset:
            zero = torch.zeros(self.b, dtype=torch.int32, device=self.device)
            self.state = self.state._replace(ev_head=zero, ev_drops=zero.clone())
        return streams
