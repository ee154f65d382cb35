"""The port's crash-and-recover harness (fuzz/crash.py) on the CPU.

The tier-1 cases of tests/fuzz/test_crash_resume.py for the three drivers
(``SimCluster``, ``ScalableCluster``, ``RoutedStorm``) at n=64, 12 ticks:
seeds 1, 7 and 8 (a torn manifest at tick 8, a flipped byte at 3, a clean
preemption at 9), a forced torn manifest at tick 8 that must resume at 6,
bit-rot and a missing shard with ``shards=2``, a clean restart when
nothing valid survived, deterministic reports; the n=1k case stays
``slow`` as in JAX.  The ``resume-bitwise`` gate must report no violation.

Added, one cross-framework crash per driver: a JAX victim runs under the
JAX harness's cadence, is killed at the seed-drawn tick (its forced save
damaged as the plan says), and the port restarts cold, recovers from the
JAX family and finishes the same schedule; its final snapshot (every
state field, the route carry and truth ring, in the stored dtypes) must
equal the JAX uninterrupted twin's.
"""

from __future__ import annotations

import numpy as np
import pytest

from ringpop_tpu.fuzz import crash as jcrash
from ringpop_tpu.fuzz import scenarios as jscenarios
from ringpop_tpu_torch.fuzz import crash
from ringpop_tpu_torch.fuzz import scenarios
from ringpop_tpu_torch.fuzz.scenarios import FULL, SCALABLE, CrashPlan, ScenarioConfig, crash_plan_of
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

CFG64 = ScenarioConfig(n=64, ticks=12)


def _no_violations(report):
    assert report.violations == [], "\n".join(v.message for v in report.violations[:4])


@pytest.mark.parametrize("driver", [FULL, SCALABLE, crash.ROUTED])
def test_crash_resume_bitwise_n64(driver, tmp_path):
    seeds = (1, 7, 8)  # torn-manifest@8, flip-byte@3, clean-preempt@9
    modes = set()
    for seed in seeds:
        plan = crash_plan_of(seed, CFG64)
        modes.add(plan.corrupt)
        report = crash.run_crash_resume(seed, str(tmp_path), driver=driver, config=CFG64,
                                        every=3, device="cpu")
        _no_violations(report)
        assert (report.kill_tick, report.corrupt) == (plan.kill_tick, plan.corrupt)
        if plan.corrupt != "none":
            assert report.skipped_errors, report
    assert "none" in modes and len(modes) >= 2, modes


@pytest.mark.parametrize("driver", [FULL, SCALABLE, crash.ROUTED])
def test_torn_mid_write_falls_back_to_previous_checkpoint(driver, tmp_path):
    report = crash.run_crash_resume(
        5, str(tmp_path), driver=driver, config=CFG64, every=3, device="cpu",
        plan=CrashPlan(kill_tick=8, corrupt="torn-manifest", frac=0.5),
    )
    _no_violations(report)
    assert report.resumed_tick == 6
    assert "CheckpointTornError" in report.skipped_errors


@pytest.mark.parametrize("mode,error", [("flip-byte", "CheckpointDigestError"),
                                        ("missing-shard", "CheckpointShardError")])
def test_bitrot_and_missing_shard_fall_back(tmp_path, mode, error):
    r = crash.run_crash_resume(
        9, str(tmp_path), driver=SCALABLE, config=CFG64, every=3, shards=2, device="cpu",
        plan=CrashPlan(kill_tick=8, corrupt=mode, frac=0.6),
    )
    _no_violations(r)
    assert error in r.skipped_errors and r.resumed_tick == 6
    assert r.damaged_file is not None and "shard-" in r.damaged_file


def test_no_valid_checkpoint_is_a_clean_restart(tmp_path):
    report = crash.run_crash_resume(
        3, str(tmp_path), driver=SCALABLE, config=CFG64, every=6, device="cpu",
        plan=CrashPlan(kill_tick=2, corrupt="torn-array", frac=0.3),
    )
    _no_violations(report)
    assert report.resumed_tick is None
    assert report.skipped_errors


def test_crash_resume_reports_are_deterministic(tmp_path):
    a = crash.run_crash_resume(13, str(tmp_path), driver=SCALABLE, config=CFG64, every=4,
                               device="cpu")
    b = crash.run_crash_resume(13, str(tmp_path), driver=SCALABLE, config=CFG64, every=4,
                               device="cpu")
    _no_violations(a)
    assert (a.kill_tick, a.corrupt, a.resumed_tick, a.skipped_errors) == (
        b.kill_tick, b.corrupt, b.resumed_tick, b.skipped_errors)


def test_sweep_and_corrupt_modes(tmp_path):
    reports = crash.sweep_crash((1, 8), str(tmp_path), driver=SCALABLE, config=CFG64,
                                device="cpu")
    assert sorted(reports) == [1, 8]
    for r in reports.values():
        _no_violations(r)
    with pytest.raises(ValueError, match="corrupt mode"):
        crash.corrupt_checkpoint(str(tmp_path), "melt", 0.5)
    with pytest.raises(ValueError, match="driver"):
        crash.build_driver("mesh", CFG64, 0, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("driver", [FULL, SCALABLE, crash.ROUTED])
def test_crash_resume_bitwise_n1k(driver, tmp_path):
    cfg = ScenarioConfig(n=1000, ticks=10)
    report = crash.run_crash_resume(
        21, str(tmp_path), driver=driver, config=cfg, every=4, device="cpu",
        plan=CrashPlan(kill_tick=7, corrupt="torn-manifest", frac=0.5),
    )
    _no_violations(report)
    assert report.resumed_tick == 4


# -- one cross-framework crash per driver --------------------------------------


def _jax_steps(drv, sched, t0, t1):
    """Step a JAX driver over ticks [t0, t1) (one compiled tick for every
    window, where ``run`` would compile a scan per window length)."""
    ins = sched.as_inputs()
    for t in range(t0, t1):
        drv.step(type(ins)(*(None if x is None else x[t] for x in ins)))


@pytest.mark.parametrize("driver", [FULL, SCALABLE, crash.ROUTED])
@pytest.mark.parametrize("seed", [1, 8])
def test_jax_victim_recovered_by_the_port(driver, seed, tmp_path):
    config = jcrash.schedule_config(driver, jscenarios.ScenarioConfig(n=64, ticks=12))
    plan = jscenarios.crash_plan_of(seed, config)
    assert tuple(plan) == tuple(crash_plan_of(seed, crash.schedule_config(driver, CFG64)))
    jsched = jscenarios.generate(seed, config)
    psched = scenarios.generate(seed, crash.schedule_config(driver, CFG64))
    fam = str(tmp_path / "fam")

    twin = jcrash.build_driver(driver, config, seed)
    _jax_steps(twin, jsched, 0, config.ticks)
    want = jcrash.snapshot(driver, twin)

    victim = jcrash.build_driver(driver, config, seed)
    victim.enable_checkpoints(fam, every=3)
    _jax_steps(victim, jsched, 0, plan.kill_tick)
    if plan.corrupt != "none":
        jcrash.corrupt_checkpoint(victim.checkpoint_now(), plan.corrupt, plan.frac)
    del victim

    port = crash.build_driver(driver, CFG64, seed, device="cpu")
    mgr = port.enable_checkpoints(fam, every=3)
    resumed = port.restore_latest()
    if plan.corrupt != "none":
        assert mgr.last_errors, "the damaged JAX checkpoint was not skipped"
    # the newest cadence line (every=3) the kill left intact; a damaged
    # forced save at a line took that line's checkpoint with it
    last = (plan.kill_tick - (plan.corrupt != "none")) // 3 * 3
    assert resumed == (last or None)
    port.run(psched.window(0 if resumed is None else resumed, CFG64.ticks))
    got = crash.snapshot(driver, port)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
