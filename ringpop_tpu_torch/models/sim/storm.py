"""ScalableCluster — the host loop around the O(N·U) engine at 100k-1M nodes.

Counterpart of ``ringpop_tpu/models/sim/storm.py``: the cluster loop behind
the 1M-node churn storm (10% fail/rejoin with ring rebalance and checksums).
Node identity is the integer index; checksums and ring points use the
commutative record hash.

``run(schedule)`` is a Python loop over the ticks (the JAX cluster scans);
each tick's metrics stay on the device until the loop ends.  The obs
planes' host halves are here: ``attach_recorder`` (an
``obs.recorder.RunRecorder`` folds every step's and run's metrics),
``emit_resolution_stat`` (the fused-exchange gauges on a statsd bridge),
``drain_histograms``, ``drain_exchange_metrics`` (both take a
``statsd=`` ``obs.statsd_bridge.StatsdBridge``), ``wavefront_snapshot`` and
``wavefront_summary``.  Checkpoints are the JAX package's format
(``models/sim/recovery.py``): ``save``/``load``, and
``enable_checkpoints(dir, every=k)``, which splits a run at every k-th
driven tick and saves there, then ``restore_latest()``;
:func:`fixup_scalable_state` aligns a loaded state's obs planes with the
resuming params.

The cluster runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.models.ring.device import (  # noqa: F401 — re-exported
    build_ring,
    device_replica_hashes,
    ring_checksum,
)
from ringpop_tpu_torch.models.sim import checkpoint as ckpt
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.cluster import _tick_at, metrics_to_numpy
from ringpop_tpu_torch.models.sim.recovery import CheckpointableMixin, CheckpointSpec, states_to
from ringpop_tpu_torch.models.sim.schedule import DeviceScheduleMixin
from ringpop_tpu_torch.obs import events as obs_events
from ringpop_tpu_torch.obs import exchange_stats as oxs
from ringpop_tpu_torch.obs import histograms as oh
from ringpop_tpu_torch.obs import perf
from ringpop_tpu_torch.ops import exchange as _exchange
from ringpop_tpu_torch.ops import histogram as hg
from ringpop_tpu_torch.ops import toolkit, u32


@dataclasses.dataclass
class StormSchedule(DeviceScheduleMixin):
    """Dense [T, N] churn plan."""

    ticks: int
    n: int
    kill: np.ndarray = None
    revive: np.ndarray = None
    # [T, N] bool graceful leaves or None (needs enable_leave=True)
    leave: np.ndarray = None
    # [T, N] int32 partition regroups (-1 keeps the group) or None
    partition: np.ndarray = None

    def __post_init__(self):
        if self.kill is None:
            self.kill = np.zeros((self.ticks, self.n), bool)
        if self.revive is None:
            self.revive = np.zeros((self.ticks, self.n), bool)

    def _build_inputs(self, device) -> es.ChurnInputs:
        def t(a, dtype):
            return None if a is None else torch.as_tensor(a, dtype=dtype, device=device)

        return es.ChurnInputs(
            kill=t(self.kill, torch.bool),
            revive=t(self.revive, torch.bool),
            partition=t(self.partition, torch.int32),
            leave=t(self.leave, torch.bool),
        )

    @staticmethod
    def churn_storm(
        ticks: int,
        n: int,
        fraction: float = 0.1,
        fail_tick: int = 1,
        rejoin_tick: Optional[int] = None,
        seed: int = 0,
    ) -> "StormSchedule":
        """Kill ``fraction`` of nodes at ``fail_tick``, revive them at
        ``rejoin_tick`` (default: halfway) — the 1M churn-storm config."""
        if rejoin_tick is None:
            rejoin_tick = ticks // 2
        rng = np.random.default_rng(seed)
        victims = rng.choice(n, size=max(1, int(n * fraction)), replace=False)
        sched = StormSchedule(ticks=ticks, n=n)
        sched.kill[fail_tick, victims] = True
        sched.revive[rejoin_tick, victims] = True
        return sched

    @staticmethod
    def sparse_churn(ticks: int, n: int, churn: int, seed: int = 0) -> "StormSchedule":
        """``churn`` random kills each tick from tick 1, each wave revived
        two ticks later: the steady trickle of bench.py's routing phase
        (its ``_sparse_churn_schedule``; the same draws)."""
        rng = np.random.default_rng(seed)
        sched = StormSchedule(ticks=ticks, n=n)
        waves = {}
        for t in range(1, ticks):
            waves[t] = rng.choice(n, size=min(churn, n), replace=False)
            sched.kill[t, waves[t]] = True
            if t - 2 in waves:
                sched.revive[t, waves[t - 2]] = True
        return sched


def fixup_scalable_state(state: es.ScalableState, params: es.ScalableParams) -> es.ScalableState:
    """Align a just-loaded ScalableState with the resuming engine's params
    (the JAX ``fixup_scalable_state``, shared by ScalableCluster and
    RoutedStorm).  The obs planes are telemetry, not trajectory: a resume
    may toggle them whatever the checkpoint carried."""
    dev = state.proc_alive.device
    if params.wavefront and state.first_heard is None:
        state = state._replace(
            first_heard=torch.full((params.n, params.u), -1, dtype=torch.int32, device=dev)
        )
    elif not params.wavefront and state.first_heard is not None:
        state = state._replace(first_heard=None)
    if params.histograms and state.hist is None:
        state = state._replace(hist=hg.init(len(es.SCALABLE_HIST_TRACKS), dev))
    elif not params.histograms and state.hist is not None:
        state = state._replace(hist=None)
    # the exchange planes: the same contract, and a resume under a
    # DIFFERENT shard count re-zeroes (counter rows are keyed by shard id)
    if params.exchange_metrics:
        s = int(params.exchange_metrics)
        if state.exch is None or int(state.exch.shape[0]) != s:
            state = state._replace(exch=_exchange.init_exchange_counters(s, dev),
                                   exch_hist=_exchange.init_exchange_hist(s, dev))
    elif state.exch is not None:
        state = state._replace(exch=None, exch_hist=None)
    return state


class ScalableCluster(CheckpointableMixin):
    """The scalable engine's cluster: construction pins the "auto" knobs
    for the device; ``step``/``run`` advance the state."""

    def __init__(
        self,
        n: int,
        params: Optional[es.ScalableParams] = None,
        replica_points: int = 16,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        params = params or es.ScalableParams(n=n)
        if params.n != n:
            params = params._replace(n=n)
        self._requested_fused_exchange = params.fused_exchange
        self.params = es.resolve_scalable_params(params, self.device.type)
        self.replica_points = replica_points
        self.state = es.init_state(self.params, seed=seed, device=self.device)
        self._replica_hashes = None
        # optional run log (attach_recorder)
        self.recorder = None

    def exchange_resolution(self) -> dict:
        """The fused-exchange resolution, in the JAX cluster's dict shape."""
        return {
            "requested": self._requested_fused_exchange,
            "mode": "inline",
            "impl": self.params.fused_exchange,
            "shards": 1,
            "cap": None,
            "single_device_resolution": self.params.fused_exchange,
            "differs_from_single_device": False,
        }

    def attach_recorder(self, recorder) -> None:
        """Attach an ``obs.recorder.RunRecorder``: later step()/run()
        metrics fold into it; the fused-exchange resolution lands as an
        ``op_resolution`` row."""
        recorder.describe("sim.engine_scalable", self.params.n, self.params)
        toolkit.emit_resolution(
            toolkit.resolution_note("fused_exchange", self._requested_fused_exchange,
                                    self.params.fused_exchange, self.device.type),
            recorder=recorder,
        )
        self.recorder = recorder

    def emit_resolution_stat(self, bridge) -> None:
        """Publish the fused-exchange resolution as ``sim.fused_exchange.*``
        gauges on an ``obs.statsd_bridge.StatsdBridge``."""
        toolkit.emit_resolution(
            toolkit.resolution_note("fused_exchange", self._requested_fused_exchange,
                                    self.params.fused_exchange, self.device.type),
            statsd=bridge,
            gauge_prefix="sim.fused_exchange",
        )

    def _recorded(self, metrics):
        with perf.span("storm.metrics_read"):
            metrics = metrics_to_numpy(metrics)
        if self.recorder is not None:
            self.recorder.record_ticks(metrics)
        return metrics

    def step(self, inputs: Optional[es.ChurnInputs] = None) -> es.ScalableMetrics:
        """One tick; returns its metrics as numpy scalars."""
        if inputs is None:
            inputs = es.ChurnInputs.quiet(self.params.n, self.device)
        self.state, m = es.tick(self.state, inputs, self.params)
        m = self._recorded(m)
        self._after_ticks(1)
        return m

    def run(self, schedule: StormSchedule) -> es.ScalableMetrics:
        """Loop the tick over the storm plan; returns ``[T]`` numpy metrics.
        With a checkpoint cadence on the run splits at the cadence lines
        (bitwise-neutral in state and metrics)."""
        with perf.span("storm.run"):
            return self._run_chunked(schedule, self._run_window)

    def _run_window(self, schedule: StormSchedule) -> es.ScalableMetrics:
        inputs = schedule.as_inputs(self.device)
        per_tick = []
        for t in range(schedule.ticks):
            with perf.span("storm.tick"):
                self.state, m = es.tick(self.state, _tick_at(inputs, t), self.params)
            per_tick.append(m)
        return self._recorded(es.ScalableMetrics(*(torch.stack(f) for f in zip(*per_tick))))

    def checksums(self) -> np.ndarray:
        """[N] uint32 membership checksums."""
        if not self.params.checksum_in_tick:
            return u32.to_numpy(es.compute_checksums(self.state, self.params))
        return u32.to_numpy(self.state.checksum)

    def ring_checksum(self) -> int:
        """Rebuild the ring from current truth, return its digest."""
        with perf.span("storm.ring"):
            if self._replica_hashes is None:
                self._replica_hashes = device_replica_hashes(
                    self.params.n, self.replica_points, self.device
                )
            # alive + suspect members stay in the ring
            # (on_membership_event.js:106-134)
            in_ring = self.state.proc_alive & (self.state.truth_status <= es.SUSPECT)
            digest = ring_checksum(build_ring(self._replica_hashes, in_ring))
            with perf.span("wait"):
                return int(u32.to_numpy(digest))

    # -- latency histograms (ScalableParams.histograms) -------------------

    def drain_histograms(self, reset: bool = True, statsd=None) -> dict:
        """Per-track summaries (exact p50/p95/p99) of ``ScalableState.hist``,
        a ``hist.drain`` row on the attached recorder and timer keys on
        ``statsd``, then (``reset``) zeroed counters."""
        if self.state.hist is None:
            raise ValueError("histograms are off — construct with ScalableParams(histograms=True)")
        summary = oh.drain(self.state.hist, es.SCALABLE_HIST_TRACKS, "sim.engine_scalable",
                           recorder=self.recorder, statsd=statsd)
        if reset:
            self.state = self.state._replace(
                hist=hg.init(len(es.SCALABLE_HIST_TRACKS), self.device)
            )
        return summary

    # -- exchange telemetry (ScalableParams.exchange_metrics) -------------

    def drain_exchange_metrics(self, reset: bool = True, statsd=None) -> dict:
        """The per-shard exchange counters through ``obs.exchange_stats.
        drain`` (priced against the default cap; ``sharded.exchange.*`` keys
        on ``statsd``), then (``reset``) zeroed planes."""
        if self.state.exch is None:
            raise ValueError(
                "exchange telemetry is off — construct with "
                "ScalableParams(exchange_metrics=<shards>)"
            )
        s = int(self.state.exch.shape[0])
        summary = oxs.drain(
            self.state.exch, self.state.exch_hist, w=int(self.state.heard.shape[1]),
            local_rows=self.params.n // s, source="sim.engine_scalable",
            recorder=self.recorder, statsd=statsd,
        )
        if reset:
            self.state = self.state._replace(
                exch=_exchange.init_exchange_counters(s, self.device),
                exch_hist=_exchange.init_exchange_hist(s, self.device),
            )
        return summary

    # -- rumor wavefront tracing (ScalableParams.wavefront) ---------------

    def wavefront_snapshot(self) -> dict:
        """Host copy of the wavefront plane: the first-heard matrix and the
        rumor births, active flags and live mask that
        ``obs.events.scalable_wavefront_summary`` needs.  Take it before a
        rumor's slot recycles (its column resets with the heard bits)."""
        if self.state.first_heard is None:
            raise ValueError("wavefront tracing is off — construct with "
                             "ScalableParams(wavefront=True)")

        def host(t):
            return t.to("cpu").numpy()

        return {
            "tick": int(self.state.tick_index),
            "first_heard": host(self.state.first_heard),
            "r_birth": host(self.state.r_birth),
            "r_active": host(self.state.r_active),
            "live": host(self.state.proc_alive),
        }

    def wavefront_summary(self) -> dict:
        """Per-rumor dissemination latencies and convergence curves of the
        current snapshot (``obs.events``)."""
        snap = self.wavefront_snapshot()
        return obs_events.scalable_wavefront_summary(
            snap["first_heard"], snap["r_birth"], snap["r_active"], snap["live"]
        )

    # -- checkpoint/resume ------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's legacy single-file checkpoint at ``path``."""
        ckpt.save_state(path, self.state, self.params)

    def load(self, path: str) -> None:
        """Resume from ``path`` — a legacy ``.npz`` file or a manifest
        checkpoint directory (any shard count), written by either package."""
        self._ckpt_install(ckpt.load_any(path, es.ScalableState, self.params))

    def _ckpt_spec(self) -> CheckpointSpec:
        return CheckpointSpec(es.ScalableState, self.params, es.NODE_SHARDED_FIELDS)

    def _ckpt_states(self):
        return self.state

    def _ckpt_install(self, state) -> None:
        self.state = fixup_scalable_state(states_to(state, self.device), self.params)
