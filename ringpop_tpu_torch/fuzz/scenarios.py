"""Seeded scenario generator: uint32 seed -> adversarial storm schedule.

Counterpart of ``ringpop_tpu/fuzz/scenarios.py``, copied over the port's
``EventSchedule`` and ``StormSchedule`` (the port imports nothing of the
JAX package): ``generate(seed, config)`` gives the same planes as the JAX
module for every seed (tests/test_torch_fuzz.py holds it).  The module
docstring there describes the move catalog; everything here is a pure
function of ``(seed, config)`` drawn from ``np.random.default_rng(seed)``,
so a failing seed replays exactly, shrinks deterministically and commits
as a fixture (:mod:`ringpop_tpu_torch.fuzz.shrinker`).

Packet loss is a per-scenario config axis (``packet_loss_of``), since it
is a static engine parameter: ``executor.sweep`` buckets seeds by level so
each level shares one executor.  ``crash_plan_of`` draws the host-level
``crash_resume`` move's plan, which :mod:`ringpop_tpu_torch.fuzz.crash`
executes.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple, Union

import numpy as np

from ringpop_tpu_torch.models.sim.cluster import EventSchedule
from ringpop_tpu_torch.models.sim.storm import StormSchedule

Schedule = Union[EventSchedule, StormSchedule]

FULL = "full"
SCALABLE = "scalable"

# bool fault planes per engine + the int32 partition plane; sparse-fault
# tuples (plane, tick, node, value) use these names
BOOL_PLANES = {
    FULL: ("kill", "revive", "join", "resume", "leave"),
    SCALABLE: ("kill", "revive", "leave"),
}
PARTITION_PLANE = "partition"


class ScenarioConfig(NamedTuple):
    """Static shape of a fuzz campaign (shared by every seed in it)."""

    engine: str = FULL
    n: int = 8
    ticks: int = 24
    # storm moves composed per scenario (1..max_moves drawn per seed)
    max_moves: int = 4
    # packet-loss menu: each seed draws ONE level (packet_loss_of); the
    # sweep buckets seeds by level so the executor count stays
    # bounded (params.packet_loss is trace-time static)
    loss_levels: Tuple[float, ...] = (0.0, 0.05, 0.2)
    max_groups: int = 3
    # leave/resume planes can be disabled (e.g. scalable runs without
    # enable_leave's 4th rumor slot)
    use_leave: bool = True
    use_resume: bool = True


def packet_loss_of(seed: int, config: ScenarioConfig) -> float:
    """The seed's packet-loss level — an independent derivation (not the
    move rng) so the schedule stream is unchanged by the loss menu."""
    if not config.loss_levels:
        return 0.0
    mixed = (((int(seed) & 0xFFFFFFFF) * 0x9E3779B9) & 0xFFFFFFFF) >> 16
    return float(config.loss_levels[mixed % len(config.loss_levels)])


class CrashPlan(NamedTuple):
    """The ``crash_resume`` move's host-level shape: when the simulating
    process is preempted and what the interrupted checkpoint write left
    behind."""

    kill_tick: int  # the process is preempted after this many ticks
    # damage to the NEWEST checkpoint (the save the kill interrupted):
    # "none" = clean preemption between saves; the rest model a torn or
    # bit-rotted artifact the recovery scan must fall back past
    corrupt: str
    frac: float  # truncation offset / flip position, as a size fraction


CRASH_CORRUPT_MODES = (
    "none",
    "torn-manifest",
    "torn-array",
    "flip-byte",
    "missing-shard",
)


def crash_plan_of(seed: int, config: ScenarioConfig) -> CrashPlan:
    """Pure ``(seed, config) -> CrashPlan`` — an independent derivation
    (not the move rng), so the storm schedule stream is unchanged by the
    crash plane, exactly like :func:`packet_loss_of`."""
    if config.ticks < 2:
        # kill_tick draws from [1, ticks); shorter windows would surface
        # as an opaque numpy low >= high error (generate() has the same
        # guard shape for its move draws)
        raise ValueError(
            "crash planning needs ticks >= 2, got %d" % config.ticks
        )
    rng = np.random.default_rng(
        (int(np.uint32(seed)) * 0x9E3779B9 + 0x5CA1AB1E) & 0xFFFFFFFF
    )
    kill_tick = int(rng.integers(1, config.ticks))
    corrupt = CRASH_CORRUPT_MODES[
        int(rng.integers(0, len(CRASH_CORRUPT_MODES)))
    ]
    frac = float(rng.uniform(0.05, 0.95))
    return CrashPlan(kill_tick=kill_tick, corrupt=corrupt, frac=frac)


def _blank_schedule(config: ScenarioConfig) -> Schedule:
    """All-quiet schedule with every usable plane dense (ONE pytree
    structure per campaign: the batched executor stacks instances, so no
    per-seed structure drift is allowed)."""
    t, n = config.ticks, config.n
    if config.engine == FULL:
        sched = EventSchedule(ticks=t, n=n)
        if config.use_resume:
            sched.resume = np.zeros((t, n), bool)
        if config.use_leave:
            sched.leave = np.zeros((t, n), bool)
        # bootstrap harness row, not a fault: every node joins at tick 0
        # (the tick-cluster 'j' command); the shrinker never removes it
        sched.join[0, :] = True
        return sched
    if config.engine != SCALABLE:
        raise ValueError("engine must be full|scalable, got %r" % (config.engine,))
    sched = StormSchedule(ticks=t, n=n)
    sched.partition = np.full((t, n), -1, np.int32)
    if config.use_leave:
        sched.leave = np.zeros((t, n), bool)
    return sched


def _victims(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    k = int(rng.integers(lo, max(lo, hi) + 1))
    return rng.choice(n, size=min(k, n), replace=False)


def _move_churn_burst(rng, sched, config):
    t0 = int(rng.integers(1, config.ticks - 1))
    d = int(rng.integers(2, max(3, config.ticks // 2)))
    victims = _victims(rng, config.n, 1, max(1, config.n // 4))
    sched.kill[t0, victims] = True
    t1 = t0 + d
    if t1 < config.ticks and rng.random() < 0.8:
        sched.revive[t1, victims] = True


def _move_suspect_pileup(rng, sched, config):
    t0 = int(rng.integers(1, config.ticks - 1))
    victims = _victims(rng, config.n, 2, max(2, config.n // 3))
    sched.kill[t0, victims] = True


def _move_flap(rng, sched, config):
    victim = int(rng.integers(0, config.n))
    period = int(rng.integers(2, 6))
    t = int(rng.integers(1, config.ticks - 1))
    up = False
    while t < config.ticks:
        (sched.revive if up else sched.kill)[t, victim] = True
        up = not up
        t += period


def _partition_plane(sched):
    # EventSchedule's partition plane is always dense; StormSchedule's is
    # made dense by _blank_schedule
    return sched.partition


def _move_split_brain(rng, sched, config):
    t0 = int(rng.integers(1, config.ticks - 1))
    g = int(rng.integers(2, config.max_groups + 1))
    groups = rng.integers(0, g, size=config.n)
    groups[int(rng.integers(0, config.n))] = 0  # group 0 is never empty
    plane = _partition_plane(sched)
    plane[t0, :] = groups.astype(np.int32)
    d = int(rng.integers(2, max(3, config.ticks // 2)))
    t1 = t0 + d
    if t1 < config.ticks and rng.random() < 0.8:
        plane[t1, :] = 0  # heal


def _move_partial_regroup(rng, sched, config):
    t0 = int(rng.integers(1, config.ticks - 1))
    movers = _victims(rng, config.n, 1, max(1, config.n // 3))
    g = int(rng.integers(0, config.max_groups))
    plane = _partition_plane(sched)
    plane[t0, movers] = np.int32(g)


def _move_leave_rejoin(rng, sched, config):
    if sched.leave is None:
        return _move_churn_burst(rng, sched, config)
    t0 = int(rng.integers(1, config.ticks - 1))
    victim = int(rng.integers(0, config.n))
    sched.leave[t0, victim] = True
    t1 = t0 + int(rng.integers(2, max(3, config.ticks // 2)))
    if t1 < config.ticks and rng.random() < 0.8:
        # rejoin: fresh incarnation + gossip restart — join input on the
        # full engine (server/admin/member.js:44-51), revive on the
        # scalable engine (its revive doubles as admin rejoin)
        if config.engine == FULL:
            sched.join[t1, victim] = True
        else:
            sched.revive[t1, victim] = True


def _move_stall_resume(rng, sched, config):
    if config.engine != FULL or sched.resume is None:
        return _move_suspect_pileup(rng, sched, config)
    t0 = int(rng.integers(1, config.ticks - 1))
    victims = _victims(rng, config.n, 1, max(1, config.n // 4))
    sched.kill[t0, victims] = True  # SIGSTOP (state kept)
    t1 = t0 + int(rng.integers(2, max(3, config.ticks // 2)))
    if t1 < config.ticks:
        sched.resume[t1, victims] = True  # SIGCONT: stale state, refutes


_MOVES = (
    _move_churn_burst,
    _move_suspect_pileup,
    _move_flap,
    _move_split_brain,
    _move_partial_regroup,
    _move_leave_rejoin,
    _move_stall_resume,
)


def generate(seed: int, config: ScenarioConfig) -> Schedule:
    """Pure ``(uint32 seed, config) -> schedule``.  Same seed, same
    planes, bit for bit — the property every downstream piece (batched
    sweep, shrinker, committed fixtures) leans on."""
    if config.ticks < 3:
        # every move draws from integers(1, ticks - 1); shorter windows
        # would surface as an opaque numpy low >= high error
        raise ValueError(
            "scenario generation needs ticks >= 3, got %d" % config.ticks
        )
    rng = np.random.default_rng(int(np.uint32(seed)))
    sched = _blank_schedule(config)
    n_moves = int(rng.integers(1, config.max_moves + 1))
    for _ in range(n_moves):
        move = _MOVES[int(rng.integers(0, len(_MOVES)))]
        move(rng, sched, config)
    return sched


# -- sparse fault form (the shrinker/fixture representation) ----------------


def sparse_faults(
    sched: Schedule, engine: str
) -> List[Tuple[str, int, int, int]]:
    """Schedule -> sorted list of (plane, tick, node, value) fault cells.

    The full engine's tick-0 bootstrap join row is harness, not fault —
    it is excluded here and re-added by :func:`schedule_from_faults`."""
    out: List[Tuple[str, int, int, int]] = []
    for plane in BOOL_PLANES[engine]:
        arr = getattr(sched, plane, None)
        if arr is None:
            continue
        ts, ns = np.nonzero(arr)
        for t, node in zip(ts.tolist(), ns.tolist()):
            if engine == FULL and plane == "join" and t == 0:
                continue  # bootstrap row
            out.append((plane, t, node, 1))
    part = getattr(sched, "partition", None)
    if part is not None:
        ts, ns = np.nonzero(np.asarray(part) >= 0)
        for t, node in zip(ts.tolist(), ns.tolist()):
            out.append((PARTITION_PLANE, t, node, int(part[t, node])))
    return sorted(out)


def schedule_from_faults(
    engine: str,
    n: int,
    ticks: int,
    faults: List[Tuple[str, int, int, int]],
    config: "ScenarioConfig | None" = None,
) -> Schedule:
    """Rebuild a schedule from its sparse fault list (fixture replay).

    ``config`` defaults to a campaign config matching (engine, n, ticks)
    with every plane enabled — the planes present must be a superset of
    the planes the faults name."""
    if config is None:
        config = ScenarioConfig(engine=engine, n=n, ticks=ticks)
    else:
        config = config._replace(engine=engine, n=n, ticks=ticks)
    sched = _blank_schedule(config)
    for plane, t, node, value in faults:
        if plane == PARTITION_PLANE:
            _partition_plane(sched)[t, node] = np.int32(value)
        else:
            arr = getattr(sched, plane, None)
            if arr is None:
                raise ValueError(
                    "fault names plane %r which this config disables" % plane
                )
            arr[t, node] = bool(value)
    return sched
