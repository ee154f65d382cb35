"""The port's lockstep parity oracle (``parity/oracle.py``) and its check
(``parity/check.py``), on the CPU.

- The port's ``OracleCluster`` against the JAX package's, on every schedule
  of tests/parity/test_lockstep.py: the checksums, ``converged``, the
  distinct count, full syncs and pings equal on every tick.
- The port's ``SimCluster(device="cpu")`` against the port's
  ``OracleCluster``: the fused tick on every one of those schedules, the
  classic tick (``fused_tick="off"``, ``fused_checksum="off"``) on
  bootstrap, kill and the n=24 churn, through ``parity.check.run_lockstep``
  (the loop ``chip_smoke.py`` runs on the card).
- ``python -m ringpop_tpu_torch.parity.check`` at n=32 on the CPU exits 0
  with the JAX script's report keys.

Equality is bitwise.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine as je
from ringpop_tpu.parity import OracleCluster as JaxOracle
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim.cluster import default_addresses
from ringpop_tpu_torch.parity import OracleCluster
from ringpop_tpu_torch.parity import check
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
CLASSIC = {"fused_tick": "off", "fused_checksum": "off"}


def quiet(ticks):
    return [{} for _ in range(ticks)]


def join_all(n):
    return [{"join": np.ones(n, bool)}]


def _mask(n, *idx):
    m = np.zeros(n, bool)
    m[list(idx)] = True
    return m


def _kill_revive(n, who, quiet_before, dead, after):
    return (join_all(n) + quiet(quiet_before) + [{"kill": _mask(n, who)}] + quiet(dead)
            + [{"revive": _mask(n, who)}] + quiet(after))


def _staggered(n):
    sched = []
    for start in range(0, n, 4):
        sched += [{"join": _mask(n, *range(start, start + 4))}] + quiet(3)
    return sched + quiet(20)


def _partition(n):
    part = np.zeros(n, np.int32)
    part[n // 2:] = 1
    return (join_all(n) + quiet(8) + [{"partition": part}] + quiet(40)
            + [{"partition": np.zeros(n, np.int32)}] + quiet(40))


def _churn(n):
    rng = np.random.default_rng(7)
    sched = join_all(n) + quiet(8)
    alive = np.ones(n, bool)
    for _ in range(6):
        kill = np.zeros(n, bool)
        revive = np.zeros(n, bool)
        for i in rng.choice(n, size=3, replace=False):
            if alive[i]:
                kill[i], alive[i] = True, False
            else:
                revive[i], alive[i] = True, True
        sched += [{"kill": kill, "revive": revive}] + quiet(9)
    return sched + quiet(45)


# name -> (n, schedule, SimParams knobs): tests/parity/test_lockstep.py's
SCHEDULES = {
    "bootstrap": (16, join_all(16) + quiet(20), {}),
    "kill": (16, join_all(16) + quiet(6) + [{"kill": _mask(16, 5)}] + quiet(40), {}),
    "revive": (16, _kill_revive(16, 3, 6, 34, 30), {}),
    "staggered_joins": (16, _staggered(16), {}),
    "packet_loss": (16, join_all(16) + quiet(40), {"packet_loss": 0.15}),
    "partition_heal": (16, _partition(16), {}),
    "churn_n24": (24, _churn(24), {}),
    "leave_rejoin": (16, join_all(16) + quiet(8) + [{"leave": _mask(16, 4)}] + quiet(25)
                     + [{"join": _mask(16, 4)}] + quiet(25), {}),
    "suspend_resume": (16, join_all(16) + quiet(6) + [{"kill": _mask(16, 6)}] + quiet(12)
                       + [{"resume": _mask(16, 6)}] + quiet(40), {}),
    "dirty_batch4": (16, _kill_revive(16, 7, 12, 34, 12), {"dirty_batch": 4}),
    "recompute_full": (16, _kill_revive(16, 7, 12, 34, 12), {"parity_recompute": "full"}),
}
CLASSIC_SCHEDULES = ("bootstrap", "kill", "churn_n24")


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_oracle_equals_jax_oracle(name):
    n, sched, knobs = SCHEDULES[name]
    addresses = default_addresses(n)
    port = OracleCluster(pe.SimParams(n=n, checksum_mode="farmhash", **knobs), addresses)
    ref = JaxOracle(je.SimParams(n=n, checksum_mode="farmhash", **knobs), addresses)
    for t, ev in enumerate(sched):
        got, want = port.tick(ev), ref.tick(ev)
        np.testing.assert_array_equal(got.checksums, want.checksums, err_msg="tick %d" % t)
        assert got.checksums.dtype == np.uint32
        assert (got.converged, got.distinct_checksums, got.full_syncs, got.pings_sent) == (
            want.converged, want.distinct_checksums, want.full_syncs, want.pings_sent), t
    np.testing.assert_array_equal(port.perm, ref.perm)
    np.testing.assert_array_equal(port.rng, ref.rng)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_fused_sim_equals_oracle(name):
    n, sched, knobs = SCHEDULES[name]
    log = io.StringIO()
    got = check.run_lockstep(pe.SimParams(n=n, checksum_mode="farmhash", **knobs), "cpu",
                             sched, mismatch_log=log)
    assert got["mismatched_ticks"] == 0, log.getvalue()[:2000]
    assert got["ticks"] == len(sched) and got["params"]["fused_checksum"] == "on"


@pytest.mark.parametrize("name", CLASSIC_SCHEDULES)
def test_classic_sim_equals_oracle(name):
    n, sched, knobs = SCHEDULES[name]
    log = io.StringIO()
    got = check.run_lockstep(pe.SimParams(n=n, checksum_mode="farmhash", **CLASSIC, **knobs),
                             "cpu", sched, mismatch_log=log)
    assert got["mismatched_ticks"] == 0, log.getvalue()[:2000]
    assert got["params"]["fused_tick"] == "off" and got["params"]["parity_recompute"] == "gated"


def test_lockstep_reports_a_mismatch():
    # a wrong oracle seed gives another decision plane: the loop must count
    # the ticks that differ, not stop at the first or pass them
    n = 16
    sched = join_all(n) + quiet(4)
    real = OracleCluster.__init__

    def off_by_one(self, params, addresses, seed=0):
        real(self, params, addresses, seed=seed + 1)

    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OracleCluster, "__init__", off_by_one)
        got = check.run_lockstep(pe.SimParams(n=n, checksum_mode="farmhash"), "cpu", sched,
                                 mismatch_log=log)
    assert got["mismatched_ticks"] > 0
    assert json.loads(log.getvalue().splitlines()[0])["tick"] >= 0


def test_schedule_matches_parity_check_script():
    n, ticks = 400, 40
    sched = check.schedule(n, ticks, seed=0)
    assert len(sched) == ticks and sched[0]["join"].all()
    pulses = [t for t, ev in enumerate(sched) if ev]
    assert pulses == [0, 5, 15, 25]  # the quiet tail is max(40 // 3, 12) = 13 ticks
    assert sched[5]["kill"].sum() == 2 and "revive" not in sched[5]
    np.testing.assert_array_equal(sched[15]["revive"], sched[5]["kill"])


def test_parity_check_cli_n32():
    proc = subprocess.run(
        [sys.executable, "-m", "ringpop_tpu_torch.parity.check", "-n", "32", "--ticks", "30",
         "--device", "cpu"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    jax_keys = {"metric", "n_nodes", "ticks", "checksum_comparisons", "mismatched_ticks",
                "parity", "converged_at_end", "elapsed_s", "checksum_mode"}
    assert jax_keys <= set(report)
    assert report["parity"] is True and report["mismatched_ticks"] == 0
    assert report["n_nodes"] == 32 and report["checksum_comparisons"] == 32 * 30
    assert report["device"] == "cpu" and report["converged_at_end"] is True


def test_parity_check_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check.main(["-n", "16", "--ticks", "2"])
