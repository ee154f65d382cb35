"""The port's request-trace plane against the JAX package, bit for bit.

Routed storms at n=64 (tests/models/test_reqtrace.py's setup: u=192,
``suspicion_ticks=4``, Q=256, a 1,024-key universe, a 15% churn storm) with
``reqtrace=True`` at ``req_sample_log2`` 0, 1 and 4, once with a capacity
that holds the window and once with one small enough to overflow: after
every tick the ``req_*`` fields (record buffer, head, drops, sampled
counters, tick stamp) must equal JAX's, and ``drain_requests`` must return
the same dict, before and after a mid-run drain resets the window.
Tolerance: none.  The device pieces (``sample_mask``, ``append_requests``)
and the host decoders are held against JAX's on their own too.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.route import plane as jplane
from ringpop_tpu.models.route import reqtrace as jrt
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu.models.sim.storm import StormSchedule as JaxSchedule
from ringpop_tpu.obs import requests as joreq
from ringpop_tpu_torch.models.route import plane as pplane
from ringpop_tpu_torch.models.route import reqtrace as prt
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from ringpop_tpu_torch.models.sim.cluster import _tick_at
from ringpop_tpu_torch.models.sim.storm import StormSchedule
from ringpop_tpu_torch.obs import requests as poreq
from ringpop_tpu_torch.ops import u32
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

N, Q, TICKS = 64, 256, 16
TRACE_FIELDS = ("req_buf", "req_head", "req_drops", "req_counts", "req_tick")


def _assert_trace_equal(j, p, where):
    for f in TRACE_FIELDS:
        a, b = np.asarray(getattr(j.rstate, f)), getattr(p.rstate, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), (where, f)


@pytest.mark.parametrize("sample_log2,capacity", [
    (0, 600),  # every key sampled: the buffer overflows on tick 3
    (1, prt.req_capacity_for(Q, TICKS)),
    (1, 900),  # about half the keys: overflows mid-run
    (4, prt.req_capacity_for(Q, TICKS)),
])
def test_trace_plane_and_drain_equal_jax(sample_log2, capacity):
    route = dict(queries_per_tick=Q, key_space=1024, reqtrace=True, req_capacity=capacity,
                 req_sample_log2=sample_log2)
    params = dict(n=N, u=192, suspicion_ticks=4)
    j = jplane.RoutedStorm(N, params=jes.ScalableParams(**params),
                           route=jplane.RouteParams(n=N, **route), seed=3)
    p = pplane.RoutedStorm(N, params=pes.ScalableParams(**params),
                           route=pplane.RouteParams(n=N, **route), seed=3, device="cpu")
    sched = JaxSchedule.churn_storm(ticks=TICKS, n=N, fraction=0.15, seed=3)
    ins = StormSchedule(ticks=TICKS, n=N, kill=sched.kill, revive=sched.revive).as_inputs("cpu")
    drains = []
    for t in range(TICKS):
        _, jrm = j.step(jes.ChurnInputs(kill=jnp.asarray(sched.kill[t]),
                                        revive=jnp.asarray(sched.revive[t])))
        _, prm = p.step(_tick_at(ins, t))
        for f in jrm._fields:
            assert int(getattr(jrm, f)) == int(getattr(prm, f)), (t, f)
        _assert_trace_equal(j, p, t)
        if t == TICKS // 2:
            got, want = p.drain_requests(), j.drain_requests()
            assert got == want
            drains.append(got)
            _assert_trace_equal(j, p, "after the drain")
    got, want = p.drain_requests(reset=False), j.drain_requests(reset=False)
    assert got == want
    drains.append(got)
    # the window reached its records, and the small buffers overflowed
    assert sum(len(d["records"]) for d in drains) > 0
    overflowed = any(d["drops"] for d in drains)
    assert overflowed == (capacity < prt.req_capacity_for(Q, TICKS) and sample_log2 < 4)


def test_sample_mask_equals_jax():
    keys = np.random.default_rng(0).integers(0, 2**32, size=4096, dtype=np.uint32)
    for log2 in (0, 1, 4, 9):
        want = np.asarray(jrt.sample_mask(jnp.asarray(keys), 0x7E57A8, log2))
        got = prt.sample_mask(u32.from_numpy(keys), 0x7E57A8, log2).numpy()
        assert np.array_equal(got, want), log2


def test_append_requests_equals_jax_through_overflow():
    rng = np.random.default_rng(1)
    cap, q = 50, 32
    jbuf, jhead, jdrops = (x for x in jrt.init_reqtrace_fields(cap)[:3])
    pbuf, phead, pdrops = prt.init_reqtrace_fields(cap)[:3]
    for step in range(6):
        mask = rng.random(q) < 0.5
        cols = [rng.integers(-2**31, 2**31, q, dtype=np.int64).astype(np.int32)
                for _ in range(poreq.RECORD_WIDTH - 1)]
        jbuf, jhead, jdrops = jrt.append_requests(
            jbuf, jhead, jdrops, jnp.asarray(mask),
            (jnp.int32(step),) + tuple(jnp.asarray(c) for c in cols))
        pbuf, phead, pdrops = prt.append_requests(
            pbuf, phead, pdrops, torch.as_tensor(mask),
            (torch.tensor(step, dtype=torch.int32),) + tuple(torch.as_tensor(c) for c in cols))
        assert np.array_equal(pbuf.numpy(), np.asarray(jbuf))
        assert int(phead) == int(jhead) and int(pdrops) == int(jdrops)
    assert int(pdrops) > 0


def test_host_registry_and_decoders_equal_jax():
    for name in ("RECORD_WIDTH", "FIELDS", "COUNT_FIELDS", "RR_NONE", "RR_LOCAL", "RR_REMOTE",
                 "OUT_CHECKSUMS_DIFFER", "OUT_CHECKSUM_REJECT", "OUT_KEYS_DIVERGED",
                 "F_TICK", "F_KEY", "F_OUTCOME"):
        assert getattr(poreq, name) == getattr(joreq, name), name
    rng = np.random.default_rng(2)
    buf = rng.integers(-2**31, 2**31, (20, poreq.RECORD_WIDTH), dtype=np.int64).astype(np.int32)
    counts = rng.integers(0, 100, len(poreq.COUNT_FIELDS)).astype(np.int32)
    for head, drops in ((0, 0), (7, 0), (20, 3)):
        a, b = poreq.decode_arrays(buf, head), joreq.decode_arrays(buf, head)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        assert poreq.decode_requests(buf, head, drops) == joreq.decode_requests(buf, head, drops)
        assert (poreq.drain(buf, head, drops, counts, 2)
                == joreq.drain(buf, head, drops, counts, 2))
    assert poreq.counts_dict(counts) == joreq.counts_dict(counts)
    assert poreq.drain_row("route", 1, 2, 3, 4, {"a": 1}) == joreq.drain_row(
        "route", 1, 2, 3, 4, {"a": 1})
    # the statsd sink: the port's bridge emits the JAX bridge's calls
    from ringpop_tpu.obs.statsd_bridge import StatsdBridge as JaxBridge
    from ringpop_tpu.utils.stats import CapturingStatsd
    from ringpop_tpu_torch.obs.statsd_bridge import StatsdBridge

    jcap, pcap = CapturingStatsd(), CapturingStatsd()
    poreq.drain(buf, 7, 3, counts, 2, statsd=StatsdBridge(statsd=pcap, host_port="h:1"))
    joreq.drain(buf, 7, 3, counts, 2, statsd=JaxBridge(statsd=jcap, host_port="h:1"))
    assert pcap.records == jcap.records and pcap.records
    with pytest.raises(ValueError):
        poreq.counts_dict(counts[:3])
