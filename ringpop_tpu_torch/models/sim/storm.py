"""ScalableCluster — the host loop around the O(N·U) engine at 100k-1M nodes.

Counterpart of ``ringpop_tpu/models/sim/storm.py``: the cluster loop behind
the 1M-node churn storm (10% fail/rejoin with ring rebalance and checksums).
Node identity is the integer index; checksums and ring points use the
commutative record hash.

``run(schedule)`` is a Python loop over the ticks (the JAX cluster scans);
each tick's metrics stay on the device until the loop ends.  Checkpoint
cadence, recorders, histogram/exchange-metric drains and the wavefront
accessors are not ported yet (ROADMAP.md), so a run is one window.

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
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.cluster import _tick_at, metrics_to_numpy
from ringpop_tpu_torch.models.sim.schedule import DeviceScheduleMixin
from ringpop_tpu_torch.ops import u32


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


class ScalableCluster:
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

    def step(self, inputs: Optional[es.ChurnInputs] = None) -> es.ScalableMetrics:
        """One tick; returns its metrics as numpy scalars."""
        if inputs is None:
            inputs = es.ChurnInputs.quiet(self.params.n, self.device)
        self.state, m = es.tick(self.state, inputs, self.params)
        return metrics_to_numpy(m)

    def run(self, schedule: StormSchedule) -> es.ScalableMetrics:
        """Loop the tick over the storm plan; returns ``[T]`` numpy metrics."""
        inputs = schedule.as_inputs(self.device)
        per_tick = []
        for t in range(schedule.ticks):
            self.state, m = es.tick(self.state, _tick_at(inputs, t), self.params)
            per_tick.append(m)
        return metrics_to_numpy(
            es.ScalableMetrics(*(torch.stack(f) for f in zip(*per_tick)))
        )

    def checksums(self) -> np.ndarray:
        """[N] uint32 membership checksums."""
        if not self.params.checksum_in_tick:
            return u32.to_numpy(es.compute_checksums(self.state, self.params))
        return u32.to_numpy(self.state.checksum)

    def ring_checksum(self) -> int:
        """Rebuild the ring from current truth, return its digest."""
        if self._replica_hashes is None:
            self._replica_hashes = device_replica_hashes(
                self.params.n, self.replica_points, self.device
            )
        # alive + suspect members stay in the ring
        # (on_membership_event.js:106-134)
        in_ring = self.state.proc_alive & (self.state.truth_status <= es.SUSPECT)
        ring = build_ring(self._replica_hashes, in_ring)
        return int(u32.to_numpy(ring_checksum(ring)))
