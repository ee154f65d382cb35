"""Driver of the full engine's ensemble: ``BatchedSimClusters``.

Set-up: B clusters (the mix's ``clusters``) of the configuration, seeds
``seed .. seed + B - 1``, the bootstrap tick and ``converge_ticks`` quiet
ticks.  A batched tick runs straight-line (every phase, every tick), so
the converge ticks warm everything the churn will run.  The victims of
the chunks the window can reach are drawn in set-up.  Each timed call is
one ``BatchedSimClusters.run`` of the mix's next chunk, from chunk 0,
which ends in the metrics' read back to the host.  The work of a tick is
B x n node-ticks.

For the check after the window the driver keeps two snapshots of the
program's state, the window's start and the start of the chunk in
flight, in device buffers allocated in set-up; :meth:`held_bytes` is
their size, which ``run.py`` leaves out of the memory peak.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.lib.snapshot import Snapshot
from portbench.lib.traffic import ChurnPlan
from portbench.reference import ensemble as ref


class Driver:
    def __init__(self, cell: dict, config: dict, mix: dict, seed: int, device, control: bool,
                 seconds: float = 0.0):
        self.engine = dict(config["engine"])
        self.n = int(self.engine["n"])
        self.b = int(mix["clusters"])
        self.converge_ticks = int(cell["converge_ticks"])
        self.seed, self.device, self.control = seed, torch.device(device), control
        self.plan = ChurnPlan(mix, self.n, seed)
        # chunks the window can reach at a second or more a chunk
        self.plan.prepare(0, math.ceil(seconds) + 2)
        self.kill = np.zeros((self.plan.chunk_ticks, self.n), bool)
        self.revive = np.zeros_like(self.kill)
        self.chunk_index = 0
        self.sim = None

    # -- the system under test (or, as the control, the reference) --------

    def _run(self, kill, revive):
        if self.control:
            return self.sim.run(kill, revive)
        return self.sim.run(self._schedule(ticks=kill.shape[0], n=self.n, kill=kill,
                                           revive=revive))

    def setup(self) -> None:
        if self.control:
            self.sim = ref.RefEnsemble(self.b, self.n, self.engine, self.seed, self.device)
        else:
            from ringpop_tpu_torch.models.sim import engine
            from ringpop_tpu_torch.models.sim.batched import BatchedSimClusters
            from ringpop_tpu_torch.models.sim.cluster import EventSchedule

            self._schedule = EventSchedule
            self.sim = BatchedSimClusters(self.b, self.n, params=engine.SimParams(**self.engine),
                                          seed=self.seed, device=self.device)
        self.sim.bootstrap()
        quiet = np.zeros((self.converge_ticks, self.n), bool)
        self._run(quiet, quiet)
        self.start_snap = Snapshot(self.sim.state)
        self.last_snap = Snapshot(self.sim.state)

    def held_bytes(self) -> int:
        return self.start_snap.nbytes + self.last_snap.nbytes

    def window_start(self) -> None:
        self.start_snap.take(self.sim.state)

    def chunk(self) -> int:
        """One timed call; returns the ticks it ran."""
        self.plan.fill(self.chunk_index, self.kill, self.revive)
        self.last_snap.take(self.sim.state)
        self.last_metrics = self._run(self.kill, self.revive)
        self.last_chunk = self.chunk_index
        self.chunk_index += 1
        return self.kill.shape[0]

    def work(self, ticks: int) -> dict:
        return {"ticks": ticks, "node_ticks": self.b * self.n * ticks}

    def counters(self) -> dict:
        return {}

    # -- correctness ------------------------------------------------------

    def judge(self, log) -> list:
        """Frees the program's own state, then runs the reference."""
        end_state = self.sim.state
        self.sim = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return ref.judge(
            b=self.b, n=self.n, engine_params=self.engine, seed=self.seed, device=self.device,
            converge_ticks=self.converge_ticks, plan=ChurnPlan(self.plan.mix, self.n, self.seed),
            start_state=self.start_snap.state, last_chunk=self.last_chunk,
            last_start=self.last_snap.state, end_state=end_state,
            last_metrics=self.last_metrics, log=log)
