"""The exchange telemetry of the port's shard mesh (the counterpart of
tests/parallel/test_exchange_telemetry.py).

With ``exchange_metrics = S`` the counters and cap-utilization histograms
come from the plane's own routing statistics, one row a shard; they must
equal the single-device analytic twin's (``_exchange_obs_update``) bit for
bit, and JAX's mesh drain.  The drain's reset, the refusals (telemetry
off, a foreign bucket count, an indivisible node count) and the
trajectory-neutrality of the counters are pinned too.  The JAX persistent
compilation cache is off in this module (``no_jax_cache``,
tests/test_torch_mesh.py).
"""

from __future__ import annotations

import numpy as np
import pytest

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.storm import StormSchedule as JaxSchedule
from ringpop_tpu.parallel import mesh as jmesh
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule
from ringpop_tpu_torch.obs import exchange_stats as oxs
from ringpop_tpu_torch.obs import histograms as oh
from ringpop_tpu_torch.obs.statsd_bridge import StatsdBridge
from ringpop_tpu_torch.ops import exchange as pexch
from ringpop_tpu_torch.ops import u32
from ringpop_tpu_torch.parallel import mesh as pmesh
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)
from tests.test_torch_mesh import no_jax_cache  # noqa: F401  (a fixture)

N, TICKS = 64, 8


def _params(n, shards, **kw):
    kw.setdefault("u", 192)
    kw.setdefault("suspicion_ticks", 5)
    return pes.ScalableParams(n=n, exchange_metrics=shards, **kw)


def _sched(ticks, n, seed=4):
    return StormSchedule.churn_storm(ticks, n, fraction=0.1, fail_tick=2, seed=seed)


def _mesh(s):
    return pmesh.make_mesh(s, device="cpu")


@pytest.fixture(scope="module")
def jax_drains(no_jax_cache):
    """JAX's mesh drain (no reset) after the same storm at 2, 4 and 8 shards."""
    out = {}
    for s in (2, 4, 8):
        js = jmesh.ShardedStorm(n=N, mesh=jmesh.make_mesh(s),
                                params=jes.ScalableParams(n=N, u=192, suspicion_ticks=5,
                                                          exchange_metrics=s), seed=4)
        js.run(JaxSchedule.churn_storm(TICKS, N, fraction=0.1, fail_tick=2, seed=4))
        out[s] = (js.drain_exchange_metrics(reset=False), np.asarray(js.state.exch),
                  np.asarray(js.state.exch_hist))
    return out


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_mesh_counters_equal_the_twin_and_jax(jax_drains, shards):
    params = _params(N, shards)
    twin = ScalableCluster(n=N, params=params, seed=4, device="cpu")
    twin.run(_sched(TICKS, N))
    storm = pmesh.ShardedStorm(n=N, mesh=_mesh(shards), params=params, seed=4)
    storm.run(_sched(TICKS, N))
    assert storm.exchange_mode == "shard_map"
    st = storm.state
    assert np.array_equal(u32.to_numpy(st.exch), u32.to_numpy(twin.state.exch))
    assert np.array_equal(u32.to_numpy(st.exch_hist), u32.to_numpy(twin.state.exch_hist))
    jdrain, jexch, jhist = jax_drains[shards]
    assert np.array_equal(u32.to_numpy(st.exch), jexch)
    assert np.array_equal(u32.to_numpy(st.exch_hist), jhist)
    mesh_drained = storm.drain_exchange_metrics(reset=False)
    twin_drained = twin.drain_exchange_metrics(reset=False)
    assert mesh_drained["shards"] == twin_drained["shards"] == jdrain["shards"]
    assert mesh_drained["totals"] == twin_drained["totals"] == jdrain["totals"]
    assert mesh_drained["reconcile"] == jdrain["reconcile"]
    rec = mesh_drained["reconcile"]
    assert rec["fallback_trips"] == 0 and rec["ratio"] == 1.0


def test_gather_twin_keeps_the_same_counters():
    """fused_exchange="plain" on the mesh (no plane): the analytic twin on
    the gathered permutation, one counter row a shard — the plane's
    counters bit for bit."""
    shards = 4
    plane = pmesh.ShardedStorm(n=N, mesh=_mesh(shards), params=_params(N, shards), seed=4)
    twin = pmesh.ShardedStorm(n=N, mesh=_mesh(shards),
                              params=_params(N, shards, fused_exchange="plain"), seed=4)
    assert twin.exchange_mode == "gspmd"
    plane.run(_sched(TICKS, N))
    twin.run(_sched(TICKS, N))
    for f in ("exch", "exch_hist", "heard", "checksum"):
        assert np.array_equal(u32.to_numpy(getattr(plane.state, f)),
                              u32.to_numpy(getattr(twin.state, f))), f
    # the twin keeps a whole plane when the bucket count is not the mesh's
    other = pmesh.ShardedStorm(n=N, mesh=_mesh(shards),
                               params=_params(N, 2, fused_exchange="plain"), seed=4)
    other.run(_sched(TICKS, N))
    single = ScalableCluster(n=N, params=_params(N, 2), seed=4, device="cpu")
    single.run(_sched(TICKS, N))
    assert np.array_equal(u32.to_numpy(other.state.exch), u32.to_numpy(single.state.exch))


def test_cap_util_pooled_equals_aggregate():
    shards = 4
    storm = pmesh.ShardedStorm(n=N, mesh=_mesh(shards), params=_params(N, shards), seed=4)
    storm.run(_sched(TICKS, N))
    hist = u32.to_numpy(storm.state.exch_hist)
    pooled = oh.summarize_batched(hist, pexch.EXCH_HIST_TRACKS)
    assert pooled == oh.summarize(hist.sum(axis=0), pexch.EXCH_HIST_TRACKS)
    assert pooled["cap_util_pull"]["count"] == shards * shards * TICKS


def test_forced_overflow_counts_fallbacks():
    shards = 8
    storm = pmesh.ShardedStorm(n=N, mesh=_mesh(shards), params=_params(N, shards), seed=4,
                               exchange_cap_override=1)
    storm.run(_sched(TICKS, N))
    tot = storm.drain_exchange_metrics(reset=False)["totals"]
    assert tot["fallback_pull"] == tot["fallback_push"] == shards * TICKS
    assert tot["a2a_pull"] == tot["a2a_push"] == 0


def test_drain_reset_starts_a_fresh_window():
    shards, ticks = 2, 4
    storm = pmesh.ShardedStorm(n=N, mesh=_mesh(shards), params=_params(N, shards), seed=4)
    storm.run(_sched(ticks, N))
    sent = []

    class _Capture:
        def gauge(self, key, value):
            sent.append(key)

        def increment(self, key, value=1):
            sent.append(key)

        def timing(self, key, value):
            sent.append(key)

    first = storm.drain_exchange_metrics(
        reset=True, statsd=StatsdBridge(statsd=_Capture(), host_port="127.0.0.1:3000"))
    assert first["totals"]["ticks"] == ticks * shards
    assert any(".sharded.exchange." in k for k in sent)
    assert not u32.to_numpy(storm.state.exch).any()
    assert not u32.to_numpy(storm.state.exch_hist).any()
    # one counter row a shard again, and the next window accumulates afresh
    assert all(st.exch.shape[0] == 1 for st in storm.shard_states)
    storm.run(_sched(ticks, N, seed=9))
    assert storm.drain_exchange_metrics(reset=False)["totals"]["ticks"] == ticks * shards


def test_refusals():
    storm = pmesh.ShardedStorm(n=N, mesh=_mesh(2), params=_params(N, 0), seed=4)
    with pytest.raises(ValueError, match="exchange telemetry is off"):
        storm.drain_exchange_metrics()
    with pytest.raises(ValueError, match="must equal the mesh size"):
        pmesh.ShardedStorm(n=N, mesh=_mesh(4), params=_params(N, 2), seed=4)
    with pytest.raises(ValueError, match="divisible"):
        pmesh.ShardedStorm(n=N, mesh=_mesh(3), params=_params(N, 0))


def test_instrumentation_is_trajectory_neutral():
    for shards in (4, 8):
        off = pmesh.ShardedStorm(n=N, mesh=_mesh(shards), params=_params(N, 0), seed=4)
        on = pmesh.ShardedStorm(n=N, mesh=_mesh(shards), params=_params(N, shards), seed=4)
        moff = off.run(_sched(TICKS, N))
        mon = on.run(_sched(TICKS, N))
        a = convert.scalable_state_to_numpy(off.state)
        b = convert.scalable_state_to_numpy(on.state)
        for f in pes.SCALABLE_TRAJECTORY_FIELDS:
            assert np.array_equal(a[f], b[f]), (shards, f)
        for f in moff._fields:
            assert np.array_equal(getattr(moff, f), getattr(mon, f)), (shards, f)


def test_drain_totals_reconcile_with_the_model():
    for shards in (2, 4, 8):
        storm = pmesh.ShardedStorm(n=N, mesh=_mesh(shards), params=_params(N, shards), seed=4)
        storm.run(_sched(TICKS, N))
        rec = storm.drain_exchange_metrics(reset=False)["reconcile"]
        assert rec["measured_interconnect"] == rec["model_interconnect"]
        assert oxs.measured_interconnect_bytes(
            storm.drain_exchange_metrics(reset=False)["totals"]) == rec["measured_interconnect"]
