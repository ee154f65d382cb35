"""Sharded checkpoints of the port's ShardedStorm (the counterpart of
tests/parallel/test_sharded_ckpt.py and of test_shard_exchange.py's
mid-storm restore).

A save writes one file a mesh shard (the manifest format both packages
share); a restore reassembles the node-indexed fields and splits them
again under the restoring mesh, so a mid-storm save resumes on another
shard count, on the single-device cluster, and on the other package —
each finishing bitwise.  The JAX persistent compilation cache is off in
this module (``no_jax_cache``, tests/test_torch_mesh.py).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.storm import StormSchedule as JaxSchedule
from ringpop_tpu.parallel import mesh as jmesh
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import checkpoint as ckpt
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.parallel import mesh as pmesh
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)
from tests.test_torch_mesh import no_jax_cache  # noqa: F401  (a fixture)

N, TICKS, CUT = 64, 20, 10
KW = dict(u=192, suspicion_ticks=5, packet_loss=0.05)


def _planes():
    base = StormSchedule.churn_storm(TICKS, N, fraction=0.1, fail_tick=2, seed=4)
    part = np.full((TICKS, N), -1, np.int32)
    part[6] = (np.arange(N) < N // 4).astype(np.int32)
    part[13] = 0
    return dict(kill=base.kill, revive=base.revive, partition=part)


def _sched():
    return StormSchedule(ticks=TICKS, n=N, **_planes())


def _jsched():
    return JaxSchedule(ticks=TICKS, n=N, **_planes())


def _params():
    return pes.ScalableParams(n=N, **KW)


def _assert_states_equal(want: dict, got, ctx=""):
    got = convert.scalable_state_to_numpy(got)
    for f in pes.ScalableState._fields:
        assert (want[f] is None and got[f] is None) or np.array_equal(want[f], got[f]), ctx + f


def _jax_state(storm) -> dict:
    return {f: None if getattr(storm.state, f) is None else np.asarray(getattr(storm.state, f))
            for f in pes.ScalableState._fields}


@pytest.fixture(scope="module")
def reference():
    ref = ScalableCluster(n=N, params=_params(), seed=4, device="cpu")
    m = ref.run(_sched())
    return convert.scalable_state_to_numpy(ref.state), m


@pytest.mark.parametrize("resume_shards", [1, 2, 8])
def test_mid_storm_restore_across_shard_counts(reference, tmp_path, resume_shards):
    """A 4-shard save at tick 10 resumes on 1, 2 and 8 shards (and on the
    single-device cluster) and finishes the storm bitwise."""
    want, m_ref = reference
    a = pmesh.ShardedStorm(n=N, mesh=pmesh.make_mesh(4, device="cpu"), params=_params(), seed=4)
    a.run(_sched().window(0, CUT))
    path = str(tmp_path / "mid")
    a.save(path)
    assert ckpt.read_manifest(path)["shards"] == 4
    assert len([f for f in os.listdir(path) if f.startswith("shard-")]) == 4
    b = pmesh.ShardedStorm(n=N, mesh=pmesh.make_mesh(resume_shards, device="cpu"),
                           params=_params(), seed=99)
    b.load(path)
    m = b.run(_sched().window(CUT, TICKS))
    _assert_states_equal(want, b.state, "%d-shard resume: " % resume_shards)
    for f in m._fields:
        if f != "mean_heard_frac" or resume_shards == 1:
            assert np.array_equal(getattr(m, f), getattr(m_ref, f)[CUT:]), f
    c = ScalableCluster(n=N, params=_params(), seed=99, device="cpu")
    c.load(path)
    c.run(_sched().window(CUT, TICKS))
    _assert_states_equal(want, c.state, "single resume: ")


def test_cadence_and_restore_latest(tmp_path):
    a = pmesh.ShardedStorm(n=N, mesh=pmesh.make_mesh(8, device="cpu"), params=_params(), seed=4)
    a.enable_checkpoints(str(tmp_path / "fam"), every=4, keep=2)
    a.run(_sched().window(0, 10))
    fams = a.checkpoint_manager.list_checkpoints()
    assert [t for t, _ in fams] == [4, 8]
    assert ckpt.read_manifest(fams[-1][1])["shards"] == 8
    b = pmesh.ShardedStorm(n=N, mesh=pmesh.make_mesh(2, device="cpu"), params=_params(), seed=1)
    b.enable_checkpoints(str(tmp_path / "fam"))
    assert b.restore_latest() == 8
    b.run(_sched().window(8, 10))
    _assert_states_equal(convert.scalable_state_to_numpy(a.state), b.state)


@pytest.fixture(scope="module")
def jax_runs(no_jax_cache, tmp_path_factory):
    """JAX's 8-shard storm to the cut (saved at 1, 2, 4 and 8 shards) and
    to the end."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    js = jmesh.ShardedStorm(n=N, mesh=jmesh.make_mesh(8), params=jes.ScalableParams(n=N, **KW),
                            seed=4)
    js.run(_jsched().window(0, CUT))
    paths = {}
    for k in (1, 2, 4, 8):
        paths[k] = str(root / ("jax%d" % k))
        js.save(paths[k], shards=k)
    js.run(_jsched().window(CUT, TICKS))
    return paths, _jax_state(js)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_jax_manifest_loads_onto_the_port_mesh(jax_runs, shards):
    paths, want = jax_runs
    assert ckpt.read_manifest(paths[shards])["shards"] == shards
    p = pmesh.ShardedStorm(n=N, mesh=pmesh.make_mesh(8, device="cpu"), params=_params(), seed=0)
    p.load(paths[shards])
    p.run(_sched().window(CUT, TICKS))
    _assert_states_equal(want, p.state, "jax %d-shard manifest: " % shards)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_port_manifest_loads_onto_the_jax_mesh(jax_runs, tmp_path, shards):
    _, want = jax_runs
    p = pmesh.ShardedStorm(n=N, mesh=pmesh.make_mesh(shards, device="cpu"), params=_params(), seed=4)
    p.run(_sched().window(0, CUT))
    path = str(tmp_path / ("port%d" % shards))
    p.save(path)
    assert ckpt.read_manifest(path)["shards"] == shards
    js = jmesh.ShardedStorm(n=N, mesh=jmesh.make_mesh(8), params=jes.ScalableParams(n=N, **KW),
                            seed=0)
    js.load(path)
    js.run(_jsched().window(CUT, TICKS))
    got = _jax_state(js)
    for f in pes.ScalableState._fields:
        assert (want[f] is None and got[f] is None) or np.array_equal(want[f], got[f]), f
