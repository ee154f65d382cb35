"""The port's Prometheus exposition (``obs/prometheus.py``, the device half)
against the JAX package's: on the same inputs the text must be byte-equal
— ``PromWriter`` samples and log2 histogram families, the drained device
histogram banks of a port run (the port reads its int32 tensors of uint32
bits, JAX the uint32 arrays), an SLO plane fed the same windows, and tick
series of each engine.  Tolerance: none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu.obs import prometheus as jprom
from ringpop_tpu.obs import slo as jslo
from ringpop_tpu_torch.models.route.plane import ROUTE_HIST_TRACKS, RoutedStorm, RouteParams
from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim import engine_scalable as es
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.models.sim.storm import StormSchedule
from ringpop_tpu_torch.obs import histograms as poh
from ringpop_tpu_torch.obs import prometheus as pprom
from ringpop_tpu_torch.obs import slo as pslo
from ringpop_tpu_torch.ops import histogram as hg
from ringpop_tpu_torch.ops import u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

LABELS = [None, {}, {"app": "ring\"pop", "instance": "a\\b\nc"}]


def _writers(fill):
    texts = []
    for mod in (jprom, pprom):
        w = mod.PromWriter()
        fill(w)
        texts.append(w.render())
    return texts


def test_writer_samples_equal_jax():
    def fill(w):
        w.sample("ringpop_a", 3, "help with\nnewline and \\ slash", "counter", {"x": "1"})
        w.sample("ringpop_b", 0.1 + 0.2, None, "gauge", {"q": 'say "hi"'})
        w.sample("ringpop_a", True, labels={"x": "2"})
        w.sample("ringpop_c", None, "dropped")
        w.sample("ringpop_b", np.float64(2.5).item())

    jt, pt = _writers(fill)
    assert pt == jt and pt.count("# TYPE ringpop_a") == 1
    assert _writers(lambda w: None) == ["", ""]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("labels", LABELS, ids=["none", "empty", "escaped"])
def test_histogram_family_equal_jax(seed, labels):
    rng = np.random.default_rng(seed)
    counts = np.zeros(hg.NBUCKETS, np.int64)
    if seed:
        hot = rng.integers(0, hg.NBUCKETS if seed == 3 else 12, size=4)
        counts[hot] = rng.integers(1, 1 << 20, size=4)
    for sum_value in (None, 12.75, 3):
        def fill(w):
            w.histogram("ringpop_h", counts, "a histogram", labels, sum_value=sum_value)
            w.sample("ringpop_g", 7, "interleaved", labels=labels)
            w.histogram("ringpop_h", counts[::-1], None, dict(labels or {}, k="2"))

        jt, pt = _writers(fill)
        assert pt == jt


def _sim_hist():
    sim = SimCluster(n=16, params=pe.SimParams(n=16, checksum_mode="fast", histograms=True),
                     seed=1, device="cpu")
    sim.bootstrap()
    metrics = sim.run(EventSchedule.churn_window(12, 16))
    return sim.state.hist, metrics


def test_device_histograms_equal_jax():
    hist, _ = _sim_hist()
    arr = u32.to_numpy(hist)
    assert arr.sum() > 0
    for labels in LABELS:
        for prefix in ("ringpop_sim_", "x_"):
            got = pprom.render_device_histograms(hist, pe.HIST_TRACKS, prefix, labels)
            assert got == jprom.render_device_histograms(arr, pe.HIST_TRACKS, prefix, labels)
            assert got == pprom.render_device_histograms(arr, pe.HIST_TRACKS, prefix, labels)
    # bits past int32: the tensor holds them negative, the text reads them unsigned
    big = np.zeros((2, hg.NBUCKETS), np.uint32)
    big[0, 3], big[1, 0] = 0xFFFF_FFF0, 7
    tensor = torch.from_numpy(big.view(np.int32))
    text = pprom.render_device_histograms(tensor, ("a", "b"))
    assert text == jprom.render_device_histograms(big, ("a", "b"))
    assert "ringpop_sim_a_count %d" % 0xFFFF_FFF0 in text


def _route_storm():
    n = 64
    rs = RoutedStorm(n, params=es.ScalableParams(n=n, u=192, suspicion_ticks=4, histograms=True),
                     route=RouteParams(n=n, queries_per_tick=256, key_space=1024, histograms=True),
                     seed=3, device="cpu")
    em, rm = rs.run(StormSchedule.churn_storm(8, n, fraction=0.2, fail_tick=1, seed=3))
    return rs, em, rm


def test_slo_plane_and_route_banks_equal_jax():
    rs, _, rm = _route_storm()
    hist = poh.host_counts(rs.rstate.hist)
    assert (pprom.render_device_histograms(rs.rstate.hist, ROUTE_HIST_TRACKS, "ringpop_route_")
            == jprom.render_device_histograms(hist, ROUTE_HIST_TRACKS, "ringpop_route_"))
    planes = []
    for slo in (jslo, pslo):
        plane = slo.SLOWindowPlane(slo.SLOTarget(name="route", success_objective=0.999),
                                   window_len=2)
        plane.observe_route_window(8, hist, rm)
        counts = np.zeros(hg.NBUCKETS, np.int64)
        counts[[0, 1, 5]] = (900, 80, 20)
        plane.observe(9, counts, queries=1000, errors=17, ticks=2)
        planes.append(plane)
    for tick in (0, 9):
        for labels in LABELS:
            got = pprom.render_slo_plane(planes[1], tick, "ringpop_slo_", labels)
            assert got == jprom.render_slo_plane(planes[0], tick, "ringpop_slo_", labels)
            # the mixed pair renders alike too: the text depends on the plane's rows
            assert got == jprom.render_slo_plane(planes[1], tick, "ringpop_slo_", labels)
    text = pprom.render_slo_plane(planes[1], 9)
    assert 'ringpop_slo_window_count{target="route"} %d' % planes[1].window_counts().sum() in text
    assert 'ringpop_slo_breach{target="route"} 1' in text


def test_tick_series_equal_jax():
    _, sim_metrics = _sim_hist()
    _, em, rm = _route_storm()
    for metrics in (sim_metrics, em, rm, sim_metrics._asdict(),
                    {f: v[-1] for f, v in sim_metrics._asdict().items()}):
        for labels in LABELS:
            got = pprom.render_tick_series(metrics, "ringpop_sim_", labels)
            assert got == jprom.render_tick_series(metrics, "ringpop_sim_", labels)
    assert pprom._COUNTERISH == jprom._COUNTERISH
    assert not hasattr(pprom, "render_ringpop_metrics")
