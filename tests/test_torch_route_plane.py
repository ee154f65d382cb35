"""The port's routing plane against the JAX package, tick by tick, bit for bit.

The setup is tests/models/test_route_plane.py's: n=64, u=192,
``suspicion_ticks=4``, Q=256 queries a tick over a 1,024-key Zipf universe,
a 30-tick 10% churn storm (fail at tick 1, rejoin at tick 15).  The port's
``RoutedStorm.step`` and the JAX one take the same inputs, and after every
tick every ``RouteState`` field (the bucketed ring's fields, or the flat
ring; the threefry key; the request-trace plane where on), every
``RouteMetrics`` field and every ``ScalableMetrics`` field must be equal,
in both ring implementations.  Tolerance: none (``mean_heard_frac``, a
float32 mean, included).  The truth ring, its checksum and the final engine state must be equal
too.  The other cases: ``enforce_consistency=False``; ``step`` equals
``run``; a port started from a JAX state converted mid-run finishes like
the JAX run; ``checksum_in_tick=False`` raises; the checkpoint entry
points, once unported, now save, load and enable a cadence
(tests/test_torch_checkpoint.py holds them against JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ringpop_tpu.models.route import plane as jplane
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.storm import StormSchedule as JaxSchedule
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.route import plane as pplane
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.cluster import _tick_at
from ringpop_tpu_torch.models.sim.storm import StormSchedule

N = 64
TICKS = 30


def _route_kw(**kw):
    base = dict(queries_per_tick=256, key_space=1024)
    base.update(kw)
    return base


def _pair(n=N, seed=1, **route_kw):
    params = dict(n=n, u=192, suspicion_ticks=4)
    route_kw = _route_kw(**route_kw)
    j = jplane.RoutedStorm(n, params=jes.ScalableParams(**params),
                           route=jplane.RouteParams(n=n, **route_kw), seed=seed)
    p = pplane.RoutedStorm(n, params=pes.ScalableParams(**params),
                           route=pplane.RouteParams(n=n, **route_kw), seed=seed, device="cpu")
    return j, p


def _storm_kw(n=N, ticks=TICKS):
    return dict(ticks=ticks, n=n, fraction=0.1, fail_tick=1, rejoin_tick=ticks // 2, seed=3)


def _jax_inputs(sched, t):
    return jes.ChurnInputs(kill=jnp.asarray(sched.kill[t]), revive=jnp.asarray(sched.revive[t]))


def _jax_route_state(st) -> dict:
    out = {}
    for f in jplane.RouteState._fields:
        v = getattr(st, f)
        if f == "ring" and v is not None:
            out[f] = {g: np.asarray(getattr(v, g)) for g in v._fields}
        else:
            out[f] = None if v is None else np.asarray(v)
    return out


def assert_route_state_equal(jst, pst, where=""):
    want = _jax_route_state(jst)
    got = convert.route_state_to_numpy(pst)
    assert set(got) == set(want)
    for f, w in want.items():
        g = got[f]
        pairs = [(f + "." + k, g[k], w[k]) for k in w] if isinstance(w, dict) else [(f, g, w)]
        for name, a, b in pairs:
            assert (a is None) == (b is None), (where, name)
            if b is not None:
                assert a.dtype == b.dtype and a.shape == b.shape, (where, name, a.dtype, b.dtype)
                assert np.array_equal(a, b), (where, name)


def assert_metrics_equal(jm, pm, where="", dtypes=True):
    """Every field equal; ``dtypes=False`` for ScalableMetrics, some of
    whose JAX sums are int64 under x64 where the port pins int32."""
    for f in jm._fields:
        a, b = np.asarray(getattr(jm, f)), np.asarray(getattr(pm, f))
        assert a.shape == b.shape and (a.dtype == b.dtype or not dtypes), (where, f)
        assert np.array_equal(a, b), (where, f, a, b)


def assert_engine_state_equal(jc, pc):
    got = convert.scalable_state_to_numpy(pc.state)
    for f in pes.ScalableState._fields:
        want = getattr(jc.state, f)
        assert (want is None and got[f] is None) or np.array_equal(got[f], np.asarray(want)), f


def run_lockstep(j, p, sched, ticks, check_state=True):
    """Step both storms through ``sched``; compare after every tick.
    Returns the port's per-tick route metrics."""
    ins = StormSchedule(ticks=sched.ticks, n=sched.n, kill=sched.kill,
                        revive=sched.revive).as_inputs("cpu")
    rows = []
    for t in range(ticks):
        jem, jrm = j.step(_jax_inputs(sched, t))
        pem, prm = p.step(_tick_at(ins, t))
        assert_metrics_equal(jem, pem, ("engine", t), dtypes=False)
        assert_metrics_equal(jrm, prm, ("route", t))
        if check_state:
            assert_route_state_equal(j.rstate, p.rstate, t)
        rows.append(prm)
    return rows


@pytest.mark.parametrize("impl", ["incremental", "full"])
def test_routed_storm_equals_jax_per_tick(impl):
    j, p = _pair(ring_impl=impl)
    assert p.route_params._asdict() == j.route_params._asdict()
    assert np.array_equal(p.cdf.numpy(), np.asarray(j.cdf))
    assert_route_state_equal(j.rstate, p.rstate, "init")
    rows = run_lockstep(j, p, JaxSchedule.churn_storm(**_storm_kw()), TICKS)
    assert np.array_equal(p.truth_ring(), np.asarray(j.truth_ring()))
    assert p.ring_checksum() == j.ring_checksum()
    assert_engine_state_equal(j.cluster, p.cluster)
    total = {f: sum(int(getattr(r, f)) for r in rows) for f in pplane.RouteMetrics._fields}
    # the storm disturbs routing: misroutes, rejects, ring motion
    assert total["route_misroutes"] > 0 and total["route_checksum_rejects"] > 0
    assert total["route_ring_changed"] > 0 and total["route_ring_dirty_buckets"] > 0


def test_enforce_consistency_off_equals_jax():
    j, p = _pair(enforce_consistency=False)
    rows = run_lockstep(j, p, JaxSchedule.churn_storm(**_storm_kw(ticks=20)), 20,
                        check_state=False)
    assert_route_state_equal(j.rstate, p.rstate)
    assert sum(int(r.route_checksums_differ) for r in rows) > 0
    assert sum(int(r.route_checksum_rejects) for r in rows) == 0


@pytest.mark.parametrize("impl", ["incremental", "full"])
def test_step_equals_run(impl):
    n = 32
    params = pes.ScalableParams(n=n, u=192, suspicion_ticks=4)
    route = pplane.RouteParams(n=n, ring_impl=impl, **_route_kw(reqtrace=True))
    sched = StormSchedule.churn_storm(**_storm_kw(n=n, ticks=8))
    a = pplane.RoutedStorm(n, params=params, route=route, seed=5, device="cpu")
    b = pplane.RoutedStorm(n, params=params, route=route, seed=5, device="cpu")
    em, rm = a.run(sched)
    ins = sched.as_inputs("cpu")
    for t in range(sched.ticks):
        sem, srm = b.step(_tick_at(ins, t))
        for stack, row in ((em, sem), (rm, srm)):
            for f in stack._fields:
                assert np.array_equal(getattr(stack, f)[t], getattr(row, f)), (t, f)
    ga, gb = convert.route_state_to_numpy(a.rstate), convert.route_state_to_numpy(b.rstate)
    for f in ga:
        x, y = ga[f], gb[f]
        if isinstance(x, dict):
            assert all(np.array_equal(x[k], y[k]) for k in x), f
        else:
            assert (x is None and y is None) or np.array_equal(x, y), f
    assert a.drain_requests() == b.drain_requests()


@pytest.mark.parametrize("impl", ["incremental", "full"])
def test_resume_from_converted_jax_state(impl):
    """Run the JAX storm 12 ticks, carry its engine and route states into
    a fresh port storm, finish both: the rest of the run is the same."""
    j, p = _pair(ring_impl=impl, reqtrace=True, req_sample_log2=1)
    sched = JaxSchedule.churn_storm(**_storm_kw())
    for t in range(12):
        j.step(_jax_inputs(sched, t))
    p.cluster.state = convert.scalable_state_from_numpy(
        {f: None if getattr(j.cluster.state, f) is None else np.asarray(getattr(j.cluster.state, f))
         for f in jes.ScalableState._fields})
    p.rstate = convert.route_state_from_numpy(_jax_route_state(j.rstate))
    assert_route_state_equal(j.rstate, p.rstate, "converted")
    rest = StormSchedule(ticks=TICKS - 12, n=N, kill=sched.kill[12:], revive=sched.revive[12:])
    jem, jrm = j.run(JaxSchedule(ticks=TICKS - 12, n=N, kill=sched.kill[12:],
                                 revive=sched.revive[12:]))
    pem, prm = p.run(rest)
    assert_metrics_equal(jem, pem, "engine", dtypes=False)
    assert_metrics_equal(jrm, prm, "route")
    assert_route_state_equal(j.rstate, p.rstate, "end")
    assert_engine_state_equal(j.cluster, p.cluster)
    assert p.ring_checksum() == j.ring_checksum()
    assert p.drain_requests() == j.drain_requests()


def test_route_params_and_resolution_like_jax():
    for kw in (dict(), dict(ring_impl="full", bucket_bits=5), dict(reqtrace=True, n=100_000)):
        jp = jplane.RouteParams(**dict(dict(n=16), **kw))
        pp = convert.route_params_from_jax_fields(jp._asdict())
        assert pp._asdict() == jp._asdict()
        assert (pplane.resolve_route_params(pp, "cuda")._asdict()
                == jplane.resolve_route_params(jp, "tpu")._asdict())
    assert pplane.RouteParams._fields == jplane.RouteParams._fields
    assert pplane.RouteMetrics._fields == jplane.RouteMetrics._fields
    assert pplane.RouteState._fields == jplane.RouteState._fields
    assert pplane.ROUTE_HIST_TRACKS == jplane.ROUTE_HIST_TRACKS
    with pytest.raises(ValueError):
        pplane.resolve_ring_impl(pplane.RouteParams(n=8, ring_impl="rbtree"))


def test_checksum_in_tick_required():
    with pytest.raises(ValueError, match="checksum_in_tick"):
        pplane.RoutedStorm(16, params=pes.ScalableParams(n=16, u=192, checksum_in_tick=False),
                           device="cpu")


def test_unported_entry_points_raise(tmp_path):
    """The checkpoint entry points that raised before they were ported
    now work: a manifest save, a load into a fresh storm, a cadence."""
    _, p = _pair(n=16)
    p.step()
    p.save(str(tmp_path / "ck"), shards=2)
    _, q = _pair(n=16, seed=9)
    q.load(str(tmp_path / "ck"))
    assert np.array_equal(q.truth_ring(), p.truth_ring())
    assert torch.equal(q.rstate.rng, p.rstate.rng)
    mgr = q.enable_checkpoints(str(tmp_path / "fam"), every=3)
    for _ in range(3):
        q.step()
    assert [t for t, _ in mgr.list_checkpoints()] == [3]
    # the histogram plane is ported: it constructs, converts and drains
    with pytest.raises(ValueError, match="histograms are off"):
        p.drain_histograms()
    h = pplane.RoutedStorm(16, params=pes.ScalableParams(n=16, u=192),
                           route=pplane.RouteParams(n=16, histograms=True), device="cpu")
    assert h.rstate.hist is not None and "route" in h.drain_histograms()
    assert convert.route_params_from_jax_fields(dict(n=16, histograms=True)).histograms
    st = dict(convert.route_state_to_numpy(p.rstate), hist=np.full((3, 32), 2**32 - 1, np.uint32))
    assert np.array_equal(convert.route_state_from_numpy(st).hist.numpy(), np.full((3, 32), -1))
    with pytest.raises(ValueError, match="reqtrace"):
        p.drain_requests()


def test_routed_storm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pplane.RoutedStorm(8, params=pes.ScalableParams(n=8, u=128))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the exchange kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["incremental", "full"])
def test_routed_storm_card_equals_cpu(cuda_device, impl):
    """The n=4096 routed storm of chip_smoke.py's phase 4: the card (the
    exchange kernel) equals the CPU (plain versions) on every tick."""
    n, ticks = 4096, 30
    params = pes.ScalableParams(n=n, u=512)
    route = pplane.RouteParams(n=n, queries_per_tick=4096, reqtrace=True, req_sample_log2=1,
                               ring_impl=impl)
    sched = StormSchedule.churn_storm(ticks, n, 0.10, fail_tick=1, rejoin_tick=15, seed=1)
    cpu = pplane.RoutedStorm(n, params=params, route=route, seed=3, device="cpu")
    card = pplane.RoutedStorm(n, params=params, route=route, seed=3, device=cuda_device)
    ins = [sched.as_inputs(s.device) for s in (cpu, card)]
    for t in range(ticks):
        (wem, wrm), (gem, grm) = cpu.step(_tick_at(ins[0], t)), card.step(_tick_at(ins[1], t))
        assert_metrics_equal(wem, gem, ("engine", t))
        assert_metrics_equal(wrm, grm, ("route", t))
        w, g = convert.route_state_to_numpy(cpu.rstate), convert.route_state_to_numpy(card.rstate)
        for f in w:
            x, y = w[f], g[f]
            if isinstance(x, dict):
                assert all(np.array_equal(x[k], y[k]) for k in x), (t, f)
            else:
                assert (x is None and y is None) or np.array_equal(x, y), (t, f)
    assert cpu.drain_requests() == card.drain_requests()


def test_sparse_churn_schedule_equals_bench():
    """``StormSchedule.sparse_churn`` (the routed main path's schedule) is
    bench.py's ``_sparse_churn_schedule``: the same kills and revives."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for n, ticks, churn in ((1000, 16, 32), (100, 8, 8), (10, 6, 20)):
        want = bench._sparse_churn_schedule(n, ticks, churn)
        got = StormSchedule.sparse_churn(ticks, n, churn)
        assert np.array_equal(got.kill, np.asarray(want.kill))
        assert np.array_equal(got.revive, np.asarray(want.revive))
