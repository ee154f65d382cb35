"""Crash-injection harness: preempt a storm, recover, prove bit-exact.

Counterpart of ``ringpop_tpu/fuzz/crash.py`` — the ``crash_resume`` move
of the scenario catalog (:mod:`.scenarios`): a driver — full-fidelity
``SimCluster``, scalable ``ScalableCluster`` or the coupled
``RoutedStorm`` — runs under a checkpoint cadence, is killed at a
seed-drawn tick (``crash_plan_of``), *including mid-checkpoint-write*
(the kill leaves a torn manifest, a truncated or bit-flipped array file,
or a missing shard — simulated at the file layer on a checkpoint the
save just committed), then restarts cold.  Recovery is the production
path: ``restore_latest()`` scans the family newest-first, falls back past
every corrupt artifact (named ``CheckpointError``s, ``ckpt.corrupt``
events), resumes from the newest valid one — or restarts clean when
nothing valid survived — and replays the rest of the SAME schedule.

The gate is the ``resume-bitwise`` invariant: the recovered final state
(every engine-state field; for RoutedStorm also the routing carry and the
materialized truth ring) must equal the uninterrupted twin's **bitwise**.
Violations ride the fuzz layer's :class:`~.invariants.Violation` shape.
Snapshots are host copies in the stored dtypes (uint32 fields as
uint32), so a report compares equal to the JAX harness's.  Drivers run on
the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import os
from itertools import count as _count
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ringpop_tpu_torch import convert
from ringpop_tpu_torch.fuzz import scenarios
from ringpop_tpu_torch.fuzz.invariants import Violation
from ringpop_tpu_torch.fuzz.scenarios import (
    FULL,
    SCALABLE,
    CrashPlan,
    ScenarioConfig,
    crash_plan_of,
)
from ringpop_tpu_torch.models.sim import checkpoint as ckpt

# third driver kind: the scalable engine + routing plane under one scan
# (schedules are the SCALABLE shape; the carry adds the route state)
ROUTED = "routed"
DRIVERS = (FULL, SCALABLE, ROUTED)

RESUME_BITWISE = "resume-bitwise"

_EXERCISE_SEQ = _count()


class CrashReport(NamedTuple):
    """One crash-and-recover exercise, everything the gates assert on."""

    violations: List[Violation]
    kill_tick: int
    corrupt: str  # damage mode applied ("none" = clean preemption)
    resumed_tick: Optional[int]  # None = no valid checkpoint, clean restart
    skipped_errors: Tuple[str, ...]  # CheckpointError class names fallen past
    checkpoints_after: int  # family size after recovery ran to completion
    damaged_file: Optional[str]


# -- drivers -----------------------------------------------------------------


def default_crash_sim_params(n: int):
    """Full-engine config for crash exercises: cheap compiles ("fast"
    checksum mode — the FarmHash parity pipeline has its own suite),
    short suspicion so suspect->faulty->refute cycles fit the window."""
    from ringpop_tpu_torch.models.sim import engine

    return engine.SimParams(n=n, checksum_mode="fast", suspicion_ticks=6)


def default_crash_scalable_params(n: int, enable_leave: bool = True):
    from ringpop_tpu_torch.fuzz.executor import default_scalable_params

    return default_scalable_params(n, enable_leave=enable_leave)


def default_crash_route_params(n: int):
    from ringpop_tpu_torch.models.route.plane import RouteParams

    return RouteParams(n=n, queries_per_tick=256, key_space=1 << 10)


def build_driver(driver: str, config: ScenarioConfig, seed: int, device=None):
    """A fresh driver, fully determined by (driver, config, seed) — the
    restarted process must reconstruct the exact same initial state."""
    if driver == FULL:
        from ringpop_tpu_torch.models.sim.cluster import SimCluster

        return SimCluster(
            n=config.n, params=default_crash_sim_params(config.n), seed=seed, device=device
        )
    if driver == SCALABLE:
        from ringpop_tpu_torch.models.sim.storm import ScalableCluster

        return ScalableCluster(
            n=config.n,
            params=default_crash_scalable_params(config.n, enable_leave=config.use_leave),
            seed=seed,
            device=device,
        )
    if driver == ROUTED:
        from ringpop_tpu_torch.models.route.plane import RoutedStorm

        return RoutedStorm(
            n=config.n,
            params=default_crash_scalable_params(config.n, enable_leave=config.use_leave),
            route=default_crash_route_params(config.n),
            seed=seed,
            device=device,
        )
    raise ValueError("driver must be one of %r, got %r" % (DRIVERS, driver))


def schedule_config(driver: str, config: ScenarioConfig) -> ScenarioConfig:
    """The generator config behind a crash driver: RoutedStorm consumes
    scalable StormSchedules."""
    return config._replace(engine=FULL if driver == FULL else SCALABLE)


def snapshot(driver_kind: str, drv) -> Dict[str, np.ndarray]:
    """Host snapshot of everything the resume-bitwise gate compares, in
    the stored dtypes (the JAX harness's keys and dtypes).

    Copies, not ``tensor.numpy()`` views: on the CPU a view shares memory
    that a later in-place tick writes, and this snapshot is held across
    other drivers' ticks."""
    out: Dict[str, np.ndarray] = {}
    if driver_kind == ROUTED:
        state = drv.cluster.state
        carry = convert.state_arrays(drv._route_carry())
        out["route.mask"] = carry["mask"]
        out["route.rng"] = carry["rng"]
        out["route.truth_ring"] = np.array(drv.truth_ring(), copy=True)
    else:
        state = drv.state
    for f, v in convert.state_arrays(state).items():
        if v is not None:
            out["state.%s" % f] = v
    return out


# -- file-layer damage (the mid-write kill) ----------------------------------


def corrupt_checkpoint(
    path: str, mode: str, frac: float
) -> Optional[str]:
    """Damage a COMMITTED checkpoint directory the way a kill mid-write
    (or bit-rot between write and read) would: truncate the manifest or
    an array file at ``frac`` of its length, flip one byte, or drop a
    shard file.  Returns the damaged file's path (None for mode
    "none")."""
    if mode == "none":
        return None
    manifest_path = os.path.join(path, ckpt.MANIFEST_NAME)

    def _array_files() -> List[str]:
        names = sorted(
            f for f in os.listdir(path) if f.endswith(".npz")
        )
        # prefer a shard file (named shard errors) over common
        shards = [f for f in names if f.startswith("shard-")]
        return [os.path.join(path, f) for f in (shards or names)]

    if mode == "torn-manifest":
        target = manifest_path
        size = os.path.getsize(target)
        with open(target, "r+b") as fh:
            fh.truncate(max(1, int(size * frac)))
        return target
    if mode == "torn-array":
        target = _array_files()[0]
        size = os.path.getsize(target)
        with open(target, "r+b") as fh:
            fh.truncate(max(1, int(size * frac)))
        return target
    if mode == "flip-byte":
        target = _array_files()[0]
        size = os.path.getsize(target)
        # land inside stored array bytes, past the zip local header (npz
        # members are STORED, not deflated, so a mid-file byte is data)
        off = min(size - 1, max(128, int(size * frac)))
        with open(target, "r+b") as fh:
            fh.seek(off)
            b = fh.read(1)
            fh.seek(off)
            fh.write(bytes([b[0] ^ 0xFF]))
        return target
    if mode == "missing-shard":
        files = _array_files()
        shards = [f for f in files if os.path.basename(f).startswith("shard-")]
        if shards:
            os.remove(shards[-1])
            return shards[-1]
        # single-file checkpoint: the nearest analog is a torn array
        return corrupt_checkpoint(path, "torn-array", frac)
    raise ValueError(
        "corrupt mode must be one of %r, got %r"
        % (scenarios.CRASH_CORRUPT_MODES, mode)
    )


# -- the harness -------------------------------------------------------------


def run_crash_resume(
    seed: int,
    workdir: str,
    *,
    driver: str = SCALABLE,
    config: Optional[ScenarioConfig] = None,
    every: int = 3,
    keep: int = 3,
    shards: int = 1,
    plan: Optional[CrashPlan] = None,
    device=None,
) -> CrashReport:
    """One full crash-and-recover exercise for ``seed``.

    1. run the seed's storm schedule uninterrupted -> reference final
       state;
    2. re-run under a checkpoint cadence and preempt at
       ``plan.kill_tick``; when the plan damages the newest checkpoint,
       force the save the kill interrupts and corrupt it at the file
       layer;
    3. restart cold: ``restore_latest()`` auto-discovers the newest
       valid checkpoint (falling back past corrupt ones, or restarting
       clean), then replays the remaining schedule window;
    4. gate every state field bitwise against the reference.

    Deterministic in (seed, config, plan, every, shards) — a failing
    report replays exactly.  The drivers run on ``device`` (the card
    unless ``"cpu"``).
    """
    config = schedule_config(
        driver, config or ScenarioConfig(n=16, ticks=12)
    )
    plan = plan or crash_plan_of(seed, config)
    if not (1 <= plan.kill_tick <= config.ticks):
        raise ValueError(
            "kill_tick %d outside [1, %d]" % (plan.kill_tick, config.ticks)
        )
    sched = scenarios.generate(seed, config)
    # per-exercise family dir: two exercises sharing (driver, seed) must
    # not resume from each other's checkpoints
    ckdir = os.path.join(
        workdir,
        "crash-%s-seed%d-%04d" % (driver, seed, next(_EXERCISE_SEQ)),
    )

    # 1. uninterrupted twin (no checkpoint plane at all: proves the
    # cadence machinery itself is trajectory-neutral)
    ref = build_driver(driver, config, seed, device)
    ref.run(sched.window(0, config.ticks))
    want = snapshot(driver, ref)

    # 2. the preempted run
    victim = build_driver(driver, config, seed, device)
    victim.enable_checkpoints(ckdir, every=every, keep=keep, shards=shards)
    victim.run(sched.window(0, plan.kill_tick))
    damaged = None
    if plan.corrupt != "none":
        # the save the preemption interrupts: committed, then damaged at
        # the file layer exactly as a mid-write kill would leave it
        newest = victim.checkpoint_now()
        damaged = corrupt_checkpoint(newest, plan.corrupt, plan.frac)
    del victim  # the process is gone

    # 3. cold restart + auto-recovery
    recovered = build_driver(driver, config, seed, device)
    mgr = recovered.enable_checkpoints(
        ckdir, every=every, keep=keep, shards=shards
    )
    resumed_tick = recovered.restore_latest()
    skipped = tuple(type(e).__name__ for _, _, e in mgr.last_errors)
    start = 0 if resumed_tick is None else resumed_tick
    recovered.run(sched.window(start, config.ticks))
    got = snapshot(driver, recovered)

    # 4. the resume-bitwise gate
    violations: List[Violation] = []
    for key in sorted(want):
        if key not in got:
            violations.append(
                Violation(RESUME_BITWISE, 0, "field %s missing after resume" % key)
            )
            continue
        a, b = want[key], got[key]
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b):
            where = (
                np.argwhere(a != b)[:4].tolist()
                if a.shape == b.shape
                else "shape %r vs %r" % (a.shape, b.shape)
            )
            violations.append(
                Violation(
                    RESUME_BITWISE,
                    0,
                    "field %s diverged after crash-resume (kill_tick=%d, "
                    "corrupt=%s, resumed=%s): %s"
                    % (key, plan.kill_tick, plan.corrupt, resumed_tick, where),
                )
            )
    for key in sorted(set(got) - set(want)):
        violations.append(
            Violation(RESUME_BITWISE, 0, "spurious field %s after resume" % key)
        )
    return CrashReport(
        violations=violations,
        kill_tick=plan.kill_tick,
        corrupt=plan.corrupt,
        resumed_tick=resumed_tick,
        skipped_errors=skipped,
        checkpoints_after=len(mgr.list_checkpoints()),
        damaged_file=damaged,
    )


def sweep_crash(
    seeds,
    workdir: str,
    *,
    driver: str = SCALABLE,
    config: Optional[ScenarioConfig] = None,
    every: int = 3,
    keep: int = 3,
    shards: int = 1,
    device=None,
) -> Dict[int, CrashReport]:
    """Crash-and-recover every seed; returns seed -> report (the sweep
    CLI and the bench fuzz gate iterate the violation lists)."""
    return {
        int(s): run_crash_resume(
            int(s),
            workdir,
            driver=driver,
            config=config,
            every=every,
            keep=keep,
            shards=shards,
            device=device,
        )
        for s in seeds
    }
