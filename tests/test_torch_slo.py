"""The port's SLO plane (``obs/slo.py``) against the JAX package's: on
seeded window counts, and on both packages' ``RoutedStorm(n=64,
histograms=True)`` drained over 3 windows of the same schedule, the
``slo.window`` / ``slo.breach`` rows, the statsd samples and the
backpressure factors must be equal.  Rates are host floats on the same
integers: equal, not within a tolerance.
"""

from __future__ import annotations

import importlib.util
import math
import os

import numpy as np
import pytest

from ringpop_tpu.models.route import plane as jplane
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.storm import StormSchedule as JaxSchedule
from ringpop_tpu.obs import slo as jslo
from ringpop_tpu.obs import statsd_bridge as jsb
from ringpop_tpu.utils.stats import CapturingStatsd
from ringpop_tpu_torch.models.route import plane as pplane
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.storm import StormSchedule
from ringpop_tpu_torch.obs import histograms as poh
from ringpop_tpu_torch.obs import slo as pslo
from ringpop_tpu_torch.obs import statsd_bridge as psb
from ringpop_tpu_torch.obs.recorder import RunRecorder
from ringpop_tpu_torch.ops import histogram as hg
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TARGETS = [
    dict(),
    dict(name="strict", success_objective=0.99, p99_max=3, burn_alert=1.5),
    dict(name="perfect", success_objective=1.0, burn_alert=4.0),
]


class _Rows:
    def __init__(self):
        self.rows = []

    def record_event(self, name, **fields):
        self.rows.append((name, fields))


def _planes(target, window_len):
    out = []
    for slo, sb in ((jslo, jsb), (pslo, psb)):
        cap = CapturingStatsd()
        plane = slo.SLOWindowPlane(slo.SLOTarget(**target), window_len=window_len,
                                   recorder=_Rows(),
                                   statsd=sb.StatsdBridge(statsd=cap, host_port="10.1.1.1:3000"),
                                   consumer=slo.SLOBackpressure(base_period_ms=200.0, max_factor=6.0))
        out.append((plane, cap))
    return out


def _same(jp, jcap, pp, pcap):
    assert pp.recorder.rows == jp.recorder.rows
    assert pcap.records == jcap.records
    assert np.array_equal(pp.window_counts(), jp.window_counts())
    assert pp.breaches == jp.breaches
    assert (pp.consumer.factor(), pp.consumer.period_ms()) == (
        jp.consumer.factor(), jp.consumer.period_ms())


@pytest.mark.parametrize("target", TARGETS, ids=["default", "strict", "perfect"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_windows_equal_jax(target, seed):
    rng = np.random.default_rng(seed)
    (jp, jcap), (pp, pcap) = _planes(target, window_len=int(rng.integers(1, 5)))
    for tick in range(12):
        counts = np.zeros(hg.NBUCKETS, np.int64)
        if rng.random() > 0.2:  # some windows are empty
            hot = rng.integers(0, 8, size=3)
            counts[hot] = rng.integers(0, 500, size=3)
        queries = int(rng.integers(0, 5000)) if rng.random() > 0.1 else 0
        errors = int(min(queries, rng.integers(0, 60)))
        ticks = int(rng.integers(1, 5))
        jrow = jp.observe(tick, counts, queries, errors, ticks=ticks)
        prow = pp.observe(tick, counts, queries, errors, ticks=ticks)
        assert prow == jrow
        _same(jp, jcap, pp, pcap)
    assert pp.window_row(99) == jp.window_row(99)
    assert pp.breaches > 0 or target == TARGETS[0]


def test_burn_rate_equal_jax():
    for errors in (0, 1, 7, 1000):
        for queries in (0, 1, 10, 999, 10_000):
            for obj in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
                got = pslo.burn_rate(errors, queries, obj)
                want = jslo.burn_rate(errors, queries, obj)
                assert got == want or (math.isinf(got) and math.isinf(want))
    assert pslo.WINDOW_QS == jslo.WINDOW_QS
    assert pslo.SLOTarget._fields == jslo.SLOTarget._fields
    assert pslo.SLOTarget() == tuple(jslo.SLOTarget())


def test_validation_and_backpressure_equal_jax():
    for slo in (jslo, pslo):
        with pytest.raises(ValueError):
            slo.SLOWindowPlane(window_len=0)
        with pytest.raises(ValueError):
            slo.SLOWindowPlane().observe(0, np.zeros(hg.NBUCKETS - 1), 1, 0)
        with pytest.raises(ValueError):
            slo.SLOBackpressure(max_factor=0.5)
    rows = [{"breach": b, "burn_rate": r} for b, r in
            ((True, 3.0), (True, 0.2), (True, None), (False, 9.0), (True, 100.0))]
    jb, pb = jslo.SLOBackpressure(150.0, 8.0), pslo.SLOBackpressure(150.0, 8.0)
    for row in rows:
        assert pb.update(row) == jb.update(row)
        assert pb.factor() == jb.factor()


def _routed_windows(plane_mod, plane_pkg, es_mod, sched_cls, device_kw, host):
    """3 windows of 4 ticks of one routed storm; each window's histogram
    read (``host``), then drained with reset, feeding an SLO plane."""
    n = 64
    rs = plane_pkg.RoutedStorm(
        n, params=es_mod.ScalableParams(n=n, u=192, suspicion_ticks=4),
        route=plane_pkg.RouteParams(n=n, queries_per_tick=256, key_space=1024, histograms=True),
        seed=2, **device_kw)
    sched = sched_cls.churn_storm(12, n, fraction=0.2, fail_tick=1, rejoin_tick=7, seed=2)
    rows, cap = _Rows(), CapturingStatsd()
    bridge = (psb if plane_mod is pslo else jsb).StatsdBridge(statsd=cap, host_port="h:1")
    plane = plane_mod.SLOWindowPlane(plane_mod.SLOTarget(success_objective=0.999, p99_max=1),
                                     window_len=2, recorder=rows, statsd=bridge,
                                     consumer=plane_mod.SLOBackpressure())
    out = []
    for w in range(3):
        _, rm = rs.run(sched.window(4 * w, 4 * w + 4))
        hist = host(rs.rstate.hist)
        drained = rs.drain_histograms(reset=True)
        out.append((plane.observe_route_window(4 * w + 4, hist, rm), drained["route"]))
    return out, rows.rows, cap.records, plane


def test_routed_storm_windows_equal_jax(tmp_path):
    jout, jrows, jrec, jplane_ = _routed_windows(jslo, jplane, jes, JaxSchedule, {}, np.asarray)
    # the port's plane reads the RouteState tensor itself (int32 of uint32 bits)
    pout, prows, prec, pplane_ = _routed_windows(pslo, pplane, pes, StormSchedule,
                                                 {"device": "cpu"}, lambda h: h)
    assert [r for r, _ in pout] == [r for r, _ in jout]
    assert [d for _, d in pout] == [d for _, d in jout]
    assert prows == jrows and prec == jrec
    assert pplane_.breaches == jplane_.breaches
    assert np.array_equal(pplane_.window_counts(), jplane_.window_counts())
    # the sliding window holds the last two drained windows' observations
    assert [r["window_ticks"] for r, _ in pout] == [4, 8, 8]
    assert int(pplane_.window_counts().sum()) == sum(
        d["retry_depth"]["count"] for _, d in pout[1:]) > 0
    assert sum(r["queries"] for r, _ in pout) > 0 and any(r["errors"] for r, _ in pout)
    # the rows ride a run log the repo's schema gate accepts
    path = str(tmp_path / "slo.runlog.jsonl")
    rec = RunRecorder(path, run_id="t", config={})
    plane = pslo.SLOWindowPlane(pslo.SLOTarget(success_objective=0.9999), window_len=2,
                                recorder=rec)
    counts = poh.host_counts(np.arange(hg.NBUCKETS, dtype=np.uint32) % 3)
    for tick in range(4):
        plane.observe(tick, counts, queries=1000, errors=tick * 10)
    rec.finish()
    spec = importlib.util.spec_from_file_location(
        "check_metrics_schema", os.path.join(REPO_ROOT, "scripts", "check_metrics_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.check([path], verbose=False) == []
    assert plane.breaches == 3
