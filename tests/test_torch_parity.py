"""The port's SimCluster (farmhash mode, CPU) in lockstep with the host
object oracle (``ringpop_tpu.parity.OracleCluster``: one host Membership
per node hashed with the C++ FarmHash), on the bootstrap, kill -> faulty
and revive schedules of tests/parity/test_lockstep.py.  Checksums and
``converged`` must be equal on every tick."""

from __future__ import annotations

import numpy as np
import torch

from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.parity import OracleCluster
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim.cluster import SimCluster, default_addresses
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

N = 16


def run_lockstep(n, schedule, seed=0):
    sim = SimCluster(n=n, params=pe.SimParams(n=n, checksum_mode="farmhash"), seed=seed,
                     device="cpu")
    oracle = OracleCluster(je.SimParams(n=n, checksum_mode="farmhash"), default_addresses(n),
                           seed=seed)
    for t, ev in enumerate(schedule):
        inputs = sim.quiet_inputs()._replace(
            **{k: torch.as_tensor(v) for k, v in ev.items()}
        )
        m = sim.step(inputs)
        res = oracle.tick(ev)
        got = sim.checksums()
        mismatch = np.flatnonzero(got != res.checksums)
        assert mismatch.size == 0, "tick %d: port/oracle checksums differ at %s" % (
            t, mismatch[:8].tolist())
        assert bool(m.converged) == res.converged, "tick %d" % t
    return sim


def quiet(ticks):
    return [{} for _ in range(ticks)]


def join_all(n):
    return [{"join": np.ones(n, bool)}]


def test_bootstrap_and_converge_n16():
    sim = run_lockstep(N, join_all(N) + quiet(20))
    assert len(sim.checksum_groups()) == 1


def test_kill_suspect_faulty_n16():
    kill = np.zeros(N, bool)
    kill[5] = True
    run_lockstep(N, join_all(N) + quiet(6) + [{"kill": kill}] + quiet(40))


def test_revive_rejoin_n16():
    kill = np.zeros(N, bool)
    kill[3] = True
    revive = np.zeros(N, bool)
    revive[3] = True
    run_lockstep(
        N,
        join_all(N) + quiet(6) + [{"kill": kill}] + quiet(34) + [{"revive": revive}] + quiet(30),
    )
