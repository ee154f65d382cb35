"""The port's recovery plane (models/sim/recovery.py) against the JAX one.

The cases of tests/models/test_recovery.py on the port's drivers: keep-K
rotation, garbage collection that never evicts the valid fallback, the
newest-first scan falling back past a torn checkpoint (with its events
and statsd counters), the saved event, a cadenced run bitwise equal in
state and stacked metrics to the unsplit run (also for ``SimCluster``
with bounded-parity overflow replays and for ``RoutedStorm``), step
cadence and restore, restore without enable, tmp leftovers.  Added: a
checkpoint family written by a JAX driver killed after a torn save and
restored by the port's ``restore_latest()``, and the reverse, each
finishing bitwise like an uninterrupted twin; and a pin that ``every=0`` adds no host read and no cadence split
to a storm tick.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from ringpop_tpu.fuzz import crash as jcrash
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.storm import ScalableCluster as JaxCluster
from ringpop_tpu.models.sim.storm import StormSchedule as JaxSchedule
from ringpop_tpu_torch.fuzz import crash as pcrash
from ringpop_tpu_torch.models.route import plane as pplane
from ringpop_tpu_torch.models.sim import checkpoint as ckpt
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.models.sim.recovery import (
    CheckpointManager,
    CheckpointSpec,
    checkpoint_name,
    host_copy_states,
)
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule

N, U = 24, 160


def _params():
    return es.ScalableParams(n=N, u=U, suspicion_ticks=4)


def _cluster(seed=5):
    return ScalableCluster(n=N, params=_params(), seed=seed, device="cpu")


def _sched(ticks=10, seed=1):
    return StormSchedule.churn_storm(ticks, N, fraction=0.2, seed=seed)


def _flip_byte(path):
    target = os.path.join(path, "common.npz")
    size = os.path.getsize(target)
    with open(target, "r+b") as fh:
        fh.seek(size // 2)
        b = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([b[0] ^ 0xFF]))


def _tear_manifest(path):
    mpath = os.path.join(path, ckpt.MANIFEST_NAME)
    with open(mpath, "r+b") as fh:
        fh.truncate(os.path.getsize(mpath) // 2)


class FakeStatsd:
    def __init__(self):
        self.counts = {}

    def increment(self, key, value=1):
        self.counts[key] = self.counts.get(key, 0) + value

    def gauge(self, key, value):
        pass


class FakeRecorder:
    def __init__(self):
        self.events = []

    def record_event(self, name, **fields):
        self.events.append((name, fields))


def _manager(tmp_path, **kw):
    c = _cluster()
    spec = CheckpointSpec(es.ScalableState, c.params, es.NODE_SHARDED_FIELDS)
    return CheckpointManager(str(tmp_path / "fam"), spec, **kw), c


def test_rotation_keeps_last_k(tmp_path):
    mgr, c = _manager(tmp_path, keep=2)
    for t in (2, 4, 6, 8):
        mgr.save(t, c.state)
    assert [t for t, _ in mgr.list_checkpoints()] == [6, 8]


def test_gc_never_evicts_the_valid_fallback(tmp_path):
    mgr, c = _manager(tmp_path, keep=1)
    ckpt.save_checkpoint(mgr.path_of(3), c.state, c.params, meta={"tick": 3})
    p6 = mgr.path_of(6)
    ckpt.save_checkpoint(p6, c.state, c.params, meta={"tick": 6})
    _tear_manifest(p6)
    assert mgr.gc() == []
    assert [t for t, _ in mgr.list_checkpoints()] == [3, 6]
    got = mgr.restore_latest()
    assert got is not None and got[0] == 3
    assert [type(e).__name__ for _, _, e in mgr.last_errors] == ["CheckpointTornError"]


def test_restore_falls_back_past_torn_then_resumes(tmp_path):
    mgr, c = _manager(tmp_path, keep=3)
    rec, statsd = FakeRecorder(), FakeStatsd()
    mgr.recorder, mgr.statsd = rec, statsd
    mgr.save(3, c.state)
    mgr.save(6, c.state)
    _tear_manifest(mgr.save(9, c.state))
    tick, state = mgr.restore_latest()
    assert tick == 6
    names = [e[0] for e in rec.events]
    assert "ckpt.corrupt" in names and "ckpt.resumed" in names
    assert [f for n, f in rec.events if n == "ckpt.corrupt"][0]["error"] == "CheckpointTornError"
    resumed = [f for n, f in rec.events if n == "ckpt.resumed"][0]
    assert resumed["tick"] == 6 and resumed["skipped_corrupt"] == 1
    assert statsd.counts["sim.ckpt.corrupt"] == 1 and statsd.counts["sim.ckpt.resumed"] == 1
    assert statsd.counts["sim.ckpt.saved"] == 3
    assert mgr.last_restore["tick"] == 6 and mgr.last_restore["scan_verify_s"] >= 0
    for _, p in mgr.list_checkpoints():
        _flip_byte(p)
    assert mgr.restore_latest() is None
    assert len(mgr.last_errors) == len(mgr.list_checkpoints())


def test_save_emits_saved_event_and_counter(tmp_path):
    mgr, c = _manager(tmp_path, keep=3, shards=2)
    rec, statsd = FakeRecorder(), FakeStatsd()
    mgr.recorder, mgr.statsd = rec, statsd
    path = mgr.save(4, c.state)
    assert os.path.basename(path) == checkpoint_name(4)
    name, fields = rec.events[0]
    assert name == "ckpt.saved"
    assert sorted(fields) == ["nbytes", "path", "shards", "tick", "wall_s"]  # the JAX row
    assert fields["tick"] == 4 and fields["shards"] == 2
    assert fields["nbytes"] > 0 and fields["wall_s"] >= 0
    assert statsd.counts["sim.ckpt.saved"] == 1
    split = mgr.last_save
    assert split["nbytes"] == fields["nbytes"]
    assert all(split[k] >= 0 for k in ("device_to_host_s", "serialise_crc_s", "write_fsync_s"))


def _sim_cluster():
    """Farmhash with a bounded recompute small enough to overflow and
    replay during the churn."""
    p = pe.SimParams(n=N, suspicion_ticks=6, parity_recompute="bounded", dirty_batch=4,
                     cell_batch=16)
    return SimCluster(n=N, params=p, seed=5, device="cpu")


def _routed():
    return pplane.RoutedStorm(N, params=_params(), route=pplane.RouteParams(
        n=N, queries_per_tick=128, key_space=512), seed=5, device="cpu")


CADENCED = {
    "scalable": (_cluster, lambda: _sched(10), "scalable"),
    "sim_bounded": (_sim_cluster, lambda: EventSchedule.churn_window(10, N), "full"),
    "routed": (_routed, lambda: _sched(10), "routed"),
}


def _flat(m):
    if isinstance(m, tuple) and not hasattr(m, "_fields"):
        return {"%d.%s" % (i, f): getattr(x, f) for i, x in enumerate(m) for f in x._fields}
    return m._asdict()


@pytest.mark.parametrize("kind", sorted(CADENCED))
def test_cadenced_run_is_bitwise_neutral(tmp_path, kind):
    """run() under a checkpoint cadence (split at cadence lines, each
    window replayed on its own overflow) equals the unsplit run bitwise —
    state AND stacked metrics — and leaves checkpoints on the grid."""
    build, sched, snap = CADENCED[kind]
    plain = build()
    m_plain = plain.run(sched())
    want = pcrash.snapshot(snap, plain)
    ck = build()
    ck.enable_checkpoints(str(tmp_path / "fam"), every=4, keep=3)
    m_ck = ck.run(sched())
    got = pcrash.snapshot(snap, ck)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    a, b = _flat(m_plain), _flat(m_ck)
    assert sorted(a) == sorted(b)
    for f in a:
        assert np.array_equal(a[f], b[f]), f
    assert [t for t, _ in ck.checkpoint_manager.list_checkpoints()] == [4, 8]
    assert ck.tick_count == 10
    if kind == "sim_bounded":
        assert plain.parity_replays > 0 and ck.parity_replays > 0


def test_step_cadence_and_restore_roundtrip(tmp_path):
    c = _cluster()
    c.enable_checkpoints(str(tmp_path / "fam"), every=2, keep=2)
    for _ in range(5):
        c.step()
    assert [t for t, _ in c.checkpoint_manager.list_checkpoints()] == [2, 4]
    d = _cluster()
    d.enable_checkpoints(str(tmp_path / "fam"))
    assert d.restore_latest() == 4
    assert d.tick_count == 4
    assert d.checkpoint_manager.last_restore["install_s"] >= 0
    for _ in range(2):
        c.step()
    want = pcrash.snapshot("scalable", c)
    for _ in range(3):
        d.step()
    got = pcrash.snapshot("scalable", d)
    for k, a in want.items():
        assert np.array_equal(a, got[k]), k


def test_host_copies_are_copies():
    """A host copy of a live state does not change when the state is
    written in place afterwards (on the CPU ``tensor.numpy()`` would), and
    holds the stored dtypes."""
    c, r = _cluster(), _routed()
    c.run(_sched(4))
    one = host_copy_states(c.state)
    both = host_copy_states({"sim": c.state, "route": r._route_carry()})
    before = one.checksum.copy()
    c.state.checksum.add_(1)
    r.rstate.rng.add_(1)
    assert np.array_equal(one.checksum, before) and one.checksum.dtype == np.uint32
    assert np.array_equal(both["sim"].checksum, before)
    assert both["route"].rng.dtype == np.uint32
    assert not np.array_equal(both["route"].rng.view(np.int32), r.rstate.rng.numpy())


def test_restore_without_enable_raises(tmp_path):
    c = _cluster()
    with pytest.raises(ValueError):
        c.restore_latest()
    with pytest.raises(ValueError):
        c.checkpoint_now()


def test_tmp_leftovers_are_ignored_by_the_scan(tmp_path):
    mgr, c = _manager(tmp_path, keep=3)
    p = mgr.save(5, c.state)
    open(os.path.join(p, "common.npz.tmp.12345"), "wb").write(b"partial")
    open(os.path.join(mgr.directory, "ckpt-0000000007.tmp"), "w").write("not a checkpoint dir")
    assert [t for t, _ in mgr.list_checkpoints()] == [5]
    got = mgr.restore_latest()
    assert got is not None and got[0] == 5


# -- a family written by one package, restored by the other -------------------


def _jax_steps(c, sched, t0, t1):
    ins = sched.as_inputs()
    for t in range(t0, t1):
        c.step(type(ins)(*(None if x is None else x[t] for x in ins)))


def _both(seed=5):
    return JaxCluster(n=N, params=jes.ScalableParams(n=N, u=U, suspicion_ticks=4), seed=seed), \
        _cluster(seed)


@pytest.mark.parametrize("shards", [1, 3])
def test_jax_family_restored_by_the_port(tmp_path, shards):
    """A JAX cluster under a cadence (every=3) is killed at tick 8 after a
    torn save; the port's restore_latest() falls back past it to tick 6
    and finishes the schedule bitwise like an uninterrupted JAX run."""
    fam = str(tmp_path / "fam")
    (victim, pc), (twin, _) = _both(), _both()
    jsched, psched = JaxSchedule.churn_storm(12, N, 0.2, seed=1), _sched(12)
    victim.enable_checkpoints(fam, every=3, keep=3, shards=shards)
    _jax_steps(victim, jsched, 0, 8)
    _tear_manifest(victim.checkpoint_now())
    _jax_steps(twin, jsched, 0, 12)
    pc.enable_checkpoints(fam, every=3, keep=3, shards=shards)
    assert pc.restore_latest() == 6
    assert [type(e).__name__ for _, _, e in pc.checkpoint_manager.last_errors] == [
        "CheckpointTornError"]
    pc.run(psched.window(6, 12))
    want, got = jcrash.snapshot("scalable", twin), pcrash.snapshot("scalable", pc)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("shards", [1, 3])
def test_port_family_restored_by_jax(tmp_path, shards):
    fam = str(tmp_path / "fam")
    (jc, victim), (_, twin) = _both(), _both()
    jsched, psched = JaxSchedule.churn_storm(12, N, 0.2, seed=1), _sched(12)
    victim.enable_checkpoints(fam, every=3, keep=3, shards=shards)
    victim.run(psched.window(0, 8))
    _tear_manifest(victim.checkpoint_now())
    twin.run(psched)
    jc.enable_checkpoints(fam, every=3, keep=3, shards=shards)
    assert jc.restore_latest() == 6
    assert [type(e).__name__ for _, _, e in jc.checkpoint_manager.last_errors] == [
        "CheckpointTornError"]
    _jax_steps(jc, jsched, 6, 12)
    want, got = jcrash.snapshot("scalable", jc), pcrash.snapshot("scalable", twin)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_every_zero_adds_no_host_read_to_a_storm_tick(tmp_path, monkeypatch):
    """With the cadence off a run is one window: no split (``window`` is
    never called), no save, and exactly the host reads of a cluster with
    no checkpoint plane at all."""
    reads = []
    for enable in (False, True):
        c = _cluster()
        if enable:
            c.enable_checkpoints(str(tmp_path / "fam"), every=0)
        monkeypatch.setattr(StormSchedule, "window", lambda *a: pytest.fail("cadence split"))
        r0 = es.host_read.count
        c.run(_sched(10))
        c.step()
        reads.append(es.host_read.count - r0)
        monkeypatch.undo()
    assert reads[0] == reads[1] > 0
    assert os.listdir(str(tmp_path / "fam")) == []
