"""Driver of the scalable engine's storm: ``ScalableCluster``.

Set-up: the cluster of the configuration from the seed (its ring with the
configuration's ``replica_points``), then the workload's ``warm_cycles``
cycles of the mix, each with its ring digest: the first builds the
ring's point table, the later ones bring the engine's tables and the
allocator to the state the window meets.  The victims of the cycles the
window can reach are drawn in set-up, and the plan's two ``[T, N]``
arrays are made once and rewritten in place.  Each timed call is one
cycle: one ``ScalableCluster.run`` of the cycle's plan (which ends in the
metrics' read back to the host), then ``ring_checksum()`` over the ring
of the nodes that stay in it: the storm's "ring rebalance + checksum".

For the check after the window the driver keeps two snapshots of the
program's state in device buffers allocated in set-up (see
``drivers/ensemble.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.lib.snapshot import Snapshot
from portbench.lib.traffic import ChurnPlan
from portbench.reference import storm as ref


class Driver:
    def __init__(self, cell: dict, config: dict, mix: dict, seed: int, device, control: bool,
                 seconds: float = 0.0):
        self.engine = dict(config["engine"])
        self.n = int(self.engine["n"])
        self.replica_points = int(config["replica_points"])
        self.warm_cycles = int(cell["warm_cycles"])
        self.seed, self.device, self.control = seed, torch.device(device), control
        self.plan = ChurnPlan(mix, self.n, seed)
        # cycles the window can reach at a second or more a cycle
        self.plan.prepare(0, self.warm_cycles + math.ceil(seconds) + 2)
        self.kill = np.zeros((self.plan.chunk_ticks, self.n), bool)
        self.revive = np.zeros_like(self.kill)
        self.chunk_index = 0
        self.sim = None
        self._host_read = None

    def _cycle(self):
        self.plan.fill(self.chunk_index, self.kill, self.revive)
        if self.control:
            metrics = self.sim.run(self.kill, self.revive)
            return metrics, self.sim.ring_digest()
        metrics = self.sim.run(self._schedule(ticks=self.kill.shape[0], n=self.n,
                                              kill=self.kill, revive=self.revive))
        return metrics, self.sim.ring_checksum()

    def setup(self) -> None:
        if self.control:
            # the guarantee the control breaks: checksums kept in the tick
            self.sim = ref.RefStorm(self.n, dict(self.engine, checksum_in_tick=False),
                                    self.seed, self.device, self.replica_points)
        else:
            from ringpop_tpu_torch.models.sim import engine_scalable as es
            from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule

            self._schedule = StormSchedule
            self._host_read = es.host_read
            self.sim = ScalableCluster(self.n, params=es.ScalableParams(**self.engine),
                                       replica_points=self.replica_points, seed=self.seed,
                                       device=self.device)
        for _ in range(self.warm_cycles):
            _, self.start_digest = self._cycle()
            self.chunk_index += 1
        self.start_snap = Snapshot(self.sim.state)
        self.last_snap = Snapshot(self.sim.state)

    def held_bytes(self) -> int:
        return self.start_snap.nbytes + self.last_snap.nbytes

    def window_start(self) -> None:
        self.start_snap.take(self.sim.state)

    def chunk(self) -> int:
        self.last_snap.take(self.sim.state)
        self.last_metrics, self.end_digest = self._cycle()
        self.last_chunk = self.chunk_index
        self.chunk_index += 1
        return self.kill.shape[0]

    def work(self, ticks: int) -> dict:
        return {"ticks": ticks, "node_ticks": self.n * ticks}

    def counters(self) -> dict:
        """The program's own count of host reads (``engine_scalable.
        host_read.count``)."""
        return {} if self._host_read is None else {"host_read": self._host_read.count}

    def judge(self, log) -> list:
        end_state = self.sim.state
        self.sim = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return ref.judge(
            n=self.n, engine_params=self.engine, replica_points=self.replica_points,
            seed=self.seed, device=self.device,
            plan=ChurnPlan(self.plan.mix, self.n, self.seed), warm_cycles=self.warm_cycles,
            start_state=self.start_snap.state, start_digest=self.start_digest,
            last_chunk=self.last_chunk, last_start=self.last_snap.state, end_state=end_state,
            last_metrics=self.last_metrics, end_digest=self.end_digest, log=log)
