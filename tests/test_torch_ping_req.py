"""The ping-req phase's kernels (``ops/ping_req.py``, ``csrc/ping_req_*.cu``)
against the engine's plain phase, bit for bit.

On the CPU the wrappers run their plain versions: the engine's route
through them (forced here; the CPU itself runs the plain phase) is held
tick by tick against the plain phase and, once, against the JAX engine;
the batching rules, the ``ping_req_slots`` counter and the select's tie
order are held too.  On the card (marked ``cuda``, no JAX) the engine
with the kernels is held against the engine with the plain phase, every
state field and metric every tick: the b32 churn pulse at B = 1, 4 and
32 under vmap and unbatched, a partition (most rows need a ping-req),
``packet_loss`` 0.05 and 0.5 (every row can), n = 1000 (not a multiple
of 32), the flight recorder and histograms on, K = 19 (more than the
select's eight keys a pass); and each kernel against its plain version
on random planes, a row with no candidate among them, K up to N.
Tolerance: none (integer planes, and one float compare of the same
float32 scores).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.func import vmap

from ringpop_tpu_torch.models.sim import engine as pe
from ringpop_tpu_torch.models.sim.batched import BatchedSimClusters
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster, _tick_at
from ringpop_tpu_torch.obs import perf
from ringpop_tpu_torch.ops import ping_req as prk
from ringpop_tpu_torch.ops import u32

K = 3


def _pulse(n, ticks, first=3, every=6, kills=3, revive_after=12, seed=5):
    """b32's churn shape, shortened: ``kills`` live nodes killed every
    ``every`` ticks from ``first``, each wave revived ``revive_after``
    ticks later."""
    rng = np.random.default_rng(seed)
    sched = EventSchedule(ticks=ticks, n=n)
    down = set()
    for t in range(first, ticks, every):
        wave = rng.choice([v for v in range(n) if v not in down], kills, replace=False)
        for v in wave:
            sched.kill[t, v] = True
            down.add(int(v))
            if t + revive_after < ticks:
                sched.revive[t + revive_after, v] = True
    return sched


def _partitioned(n, ticks, split_at=3, heal_at=None):
    """Two halves from ``split_at`` (healed at ``heal_at``): most direct
    pings across the cut fail, so most rows need a ping-req."""
    sched = EventSchedule(ticks=ticks, n=n)
    sched.partition[split_at] = (np.arange(n) >= n // 2).astype(np.int32)
    if heal_at is not None:
        sched.partition[heal_at] = 0
    return sched


def _stepper(n, sched, b, device, seed, knobs):
    """One tick of a cluster at a time (``b`` None: ``SimCluster``, gated)
    or of ``b`` clusters under vmap (``BatchedSimClusters``): a function
    of the tick returning ``(state, metrics)``."""
    params = pe.SimParams(n=n, suspicion_ticks=6, **knobs)
    if b is None:
        sim = SimCluster(n=n, params=params, seed=seed, device=device)
        sim.bootstrap()
        inputs = sched.as_inputs(sim.device)

        def step(t):
            m = sim.step(_tick_at(inputs, t))
            return sim.state, m
        return step
    bat = BatchedSimClusters(b, n, params=params, seed=seed, device=device)
    bat.bootstrap()
    inputs = sched.as_inputs(bat.device)

    def step(t):
        bat.state, m = bat._tick(bat.state, _tick_at(inputs, t))
        return bat.state, m
    return step


def _assert_routes_equal(monkeypatch, n, sched, what, b=None, device="cpu", seed=3, **knobs):
    """The same cluster twice, one ticking with the ping-req phase's route
    forced to the kernels and one to the plain ops, held equal every
    field and metric after every tick (tick by tick: the B = 32 states of
    a whole run would not fit the card).  Returns the ping-reqs sent and
    the last states."""
    route = {}
    monkeypatch.setattr(pe, "_ping_req_kernels", lambda *a: route["kernels"])
    steppers = {}
    for kernels in (True, False):
        route["kernels"] = kernels
        steppers[kernels] = _stepper(n, sched, b, device, seed, knobs)
    prs = 0
    for t in range(sched.ticks):
        out = {}
        for kernels in (True, False):
            route["kernels"] = kernels
            out[kernels] = steppers[kernels](t)
        (gs, gm), (ws, wm) = out[True], out[False]
        for f in pe.SimState._fields:
            g, w = getattr(gs, f), getattr(ws, f)
            assert (g is None) == (w is None), (what, t, f)
            if g is not None:
                assert torch.equal(g, w), "%s: tick %d state field %s differs" % (what, t, f)
        for f in pe.TickMetrics._fields:
            assert torch.equal(torch.as_tensor(getattr(gm, f)), torch.as_tensor(getattr(wm, f))), \
                "%s: tick %d metric %s differs" % (what, t, f)
        prs += int(torch.as_tensor(wm.ping_reqs).sum())
    return prs


CPU_CASES = {
    "pulse": dict(n=64, sched=lambda n: _pulse(n, 24)),
    "partition": dict(n=45, sched=lambda n: _partitioned(n, 14, heal_at=10),
                      checksum_mode="fast"),
    "loss-0.05": dict(n=40, sched=lambda n: _pulse(n, 14), packet_loss=0.05,
                      checksum_mode="fast"),
    "loss-0.5": dict(n=40, sched=lambda n: EventSchedule(ticks=10, n=n), packet_loss=0.5,
                     checksum_mode="fast"),
    "planes": dict(n=40, sched=lambda n: _pulse(n, 16), flight_recorder=True, histograms=True,
                   packet_loss=0.05, checksum_mode="fast"),
    "k-19": dict(n=40, sched=lambda n: _pulse(n, 10), packet_loss=0.3, ping_req_size=19,
                 checksum_mode="fast"),
}


@pytest.mark.parametrize("b", [None, 3])
@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_kernel_route_equals_plain_phase_on_cpu(monkeypatch, case, b):
    """The engine through ``ping_req_select`` / ``ping_req_combine`` /
    ``ping_req_hits`` / ``ping_req_respond`` (their plain versions here)
    equals the engine's own plain phase, every field every tick."""
    kw = dict(CPU_CASES[case])
    n = kw.pop("n")
    sched = kw.pop("sched")(n)
    assert _assert_routes_equal(monkeypatch, n, sched, "%s b=%s" % (case, b), b=b, **kw) > 0


def test_kernel_route_equals_jax_engine(monkeypatch):
    """The route through the plain versions against the JAX engine, tick
    by tick, at 20% loss (ping-reqs, suspects and refutes every tick)."""
    import jax
    import jax.numpy as jnp

    from ringpop_tpu.models.sim import engine as je
    from ringpop_tpu.ops import checksum_encode as jce
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models.sim.cluster import default_addresses
    from ringpop_tpu_torch.ops import checksum_encode as pce

    n, ticks = 48, 16
    addrs = default_addresses(n)
    ju, pu = jce.Universe.from_addresses(addrs), pce.Universe.from_addresses(addrs)
    jp = je.SimParams(n=n, checksum_mode="fast", suspicion_ticks=6, gate_phases=False,
                      fused_tick="xla", packet_loss=0.2)
    pp = convert.params_from_jax_fields(jp._asdict())
    monkeypatch.setattr(pe, "_ping_req_kernels", lambda *a: True)
    js = je.init_state(jp, seed=2, universe=ju)
    ps = convert.state_from_numpy(
        {f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
         for f in je.SimState._fields}, pp)
    jtick = jax.jit(lambda s, i: je.tick(s, i, jp, ju))
    sched = _pulse(n, ticks)
    prs = 0
    for t in range(-1, ticks):
        ev = dict(kill=np.zeros(n, bool), revive=np.zeros(n, bool), join=np.full(n, t < 0),
                  partition=np.full(n, -1, np.int32))
        if t >= 0:
            ev.update(kill=sched.kill[t], revive=sched.revive[t])
        js, jm = jtick(js, je.TickInputs(**{k: jnp.asarray(v) for k, v in ev.items()}))
        ps, pm = pe.tick(ps, pe.TickInputs(**{k: torch.as_tensor(v) for k, v in ev.items()}),
                         pp, pu)
        got = convert.state_to_numpy(ps)
        for f in je.SimState._fields:
            if getattr(js, f) is not None:
                assert np.array_equal(got[f], np.asarray(getattr(js, f))), (t, f)
        for f in pe.TickMetrics._fields:
            assert int(getattr(pm, f)) == int(getattr(jm, f)), (t, f)
        prs += int(pm.ping_reqs)
    assert prs > 0


def test_cpu_runs_the_plain_phase_and_the_counter_reads_shapes(monkeypatch):
    """On the CPU the route is the plain phase (no wrapper runs, nothing
    counted); the forced route under vmap counts B * N * K slots a tick,
    from shapes: a host read of a batched value would raise there."""
    n, b, ticks = 40, 3, 4
    sched = _pulse(n, ticks, first=1, every=1, kills=2)
    assert not pe._ping_req_kernels(pe.resolve_fused_tick(pe.SimParams(n=n), "cpu"),
                                    pe.Solo(n), n)
    assert pe._ping_req_kernels("kernel", pe.Solo(n), n)
    assert not pe._ping_req_kernels("kernel", type("Shard", (), {"rows": n // 2})(), n)

    calls = []
    real = prk.ping_req_select
    monkeypatch.setattr(prk, "ping_req_select", lambda *a: calls.append(1) or real(*a))
    bat = BatchedSimClusters(b, n, params=pe.SimParams(n=n), seed=1, device="cpu")
    bat.bootstrap()
    timer = perf.DispatchTimer()
    with perf.tracing(timer):
        bat.run(sched)
    assert calls == [] and "ping_req_slots" not in timer.counters
    names = {row[0] for row in timer.log}
    assert "ping_req" in names and not names & {"ping_req.select", "ping_req.combine",
                                                "ping_req.respond"}

    monkeypatch.setattr(pe, "_ping_req_kernels", lambda *a: True)
    timer = perf.DispatchTimer()
    with perf.tracing(timer):
        bat.run(sched)
    assert len(calls) == ticks
    assert timer.counters["ping_req_slots"] == ticks * b * n * K
    names = [row[0] for row in timer.log]
    assert names.count("ping_req.select") == ticks
    assert names.count("ping_req.combine") == ticks
    assert names.count("ping_req.respond") == 2 * ticks  # the hits, then the responses


def _select_inputs(rows, n, seed, dev="cpu", need=0.5, pingable=0.7):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.random((rows, n)) < pingable, device=dev),
            torch.as_tensor(rng.integers(-1, n, rows).astype(np.int32), device=dev),
            torch.as_tensor(rng.random(rows) < need, device=dev),
            u32.from_numpy(rng.integers(0, 2**32, (rows, 2), dtype=np.uint32), dev))


def test_select_plain_ties_and_empty_rows():
    """A row with no candidate, or no need, gets columns 0..K-1, none
    valid; a row with fewer candidates than K lists them first, then the
    lowest other columns; every valid column is a candidate, in score
    order."""
    pingable, target, need, rng = _select_inputs(6, 37, 4)
    pingable[0] = False
    need[0] = need[1] = True
    need[2] = False
    pingable[3] = False
    pingable[3, [5, 30]] = True
    target[3] = 30
    need[3] = True
    sel, valid = prk.ping_req_select_plain(pingable, target, need, rng, K)
    assert sel.dtype == torch.int64 and sel.shape == (6, K)
    for r in (0, 2):
        assert sel[r].tolist() == [0, 1, 2] and not valid[r].any()
    assert sel[3].tolist() == [5, 0, 1] and valid[3].tolist() == [True, False, False]
    score = prk.select_scores(rng[:, 0], 37)
    for r in range(6):
        s = sel[r][valid[r]]
        assert bool((pingable[r, s] & (s != target[r].long())).all())
        assert bool((score[r, s][1:] >= score[r, s][:-1]).all())


def _rule_equals_stacked_plain(name):
    """A custom op's batching rule (a loop of plain calls on the CPU)
    equals the plain version per cluster."""
    b, n = 3, 33
    for k in (K, 19):
        args = _phase_inputs(b, n, 8, k=k)[name]
        got = vmap(_piece(name, k=k))(*args)
        for i in range(b):
            _equal(tuple(g[i] for g in _outs(got)),
                   _piece(name, plain=True, k=k)(*(a[i] for a in args)),
                   "%s K=%d cluster %d" % (name, k, i))


def test_ping_req_select_rule_equals_stacked_plain():
    _rule_equals_stacked_plain("ping_req_select")


def test_ping_req_combine_rule_equals_stacked_plain():
    _rule_equals_stacked_plain("ping_req_combine")


def test_ping_req_hits_rule_equals_stacked_plain():
    _rule_equals_stacked_plain("ping_req_hits")


def test_ping_req_respond_rule_equals_stacked_plain():
    _rule_equals_stacked_plain("ping_req_respond")


# each piece's wrapper and its plain version
PIECES = {
    "ping_req_select": (prk.ping_req_select, prk.ping_req_select_plain),
    "ping_req_combine": (prk.ping_req_combine, prk.ping_req_combine_plain),
    "ping_req_hits": (prk.ping_req_hits, prk.ping_req_hits_plain),
    "ping_req_respond": (prk.ping_req_respond, prk.ping_req_respond_plain),
}


def _piece(name, plain=False, k=K):
    """A piece as a function of its tensors (the select's K bound)."""
    fn = PIECES[name][plain]
    return (lambda *a: fn(*a, k)) if name == "ping_req_select" else fn


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def _phase_inputs(b, n, seed, dev="cpu", need=0.5, respond=0.7, k=K):
    """Random operands of the four pieces for ``b`` clusters of ``n``
    (each piece's argument tuple, cluster first); the intermediaries from
    the plain select, so each row's slots are distinct columns."""
    rng = np.random.default_rng(seed)

    def planes(lo, hi, dtype=np.int32):
        return torch.as_tensor(rng.integers(lo, hi, (b, n, n)).astype(dtype), device=dev)

    def mask(p, shape=(n, n)):
        return torch.as_tensor(rng.random((b,) + shape) < p, device=dev)

    sel_args = [torch.stack(x) for x in zip(*(
        _select_inputs(n, n, seed * 31 + i, dev, need=need) for i in range(b)))]
    sel, valid = prk.ping_req_select_plain(*sel_args, k)
    responder = valid & mask(respond, (n, k))
    inc = planes(0, 40)
    own = torch.arange(n, device=dev)
    inc[:, own, own] = planes(1, 40)[:, 0]
    mid = torch.as_tensor(rng.integers(0, 3, (b, n)).astype(np.int32), device=dev)
    self_inc = torch.as_tensor(rng.integers(1, 40, (b, n)).astype(np.int32), device=dev)
    source = planes(-1, n)
    return {
        "ping_req_select": tuple(sel_args),
        "ping_req_combine": (sel, responder, mask(0.4), planes(0, 12),
                             torch.as_tensor(rng.integers(5, 15, (b, n)).astype(np.int32),
                                             device=dev),
                             planes(0, 40), planes(0, 4), source, planes(0, 40)),
        "ping_req_hits": (sel, responder, mask(0.4), source,
                          torch.where(mask(0.5), self_inc[:, None, :].expand(b, n, n)
                                      .gather(2, source.clamp(0).long()), planes(0, 40)),
                          self_inc),
        "ping_req_respond": (sel, responder, mask(0.05), source, planes(0, 40), mask(0.8),
                             planes(0, 4), inc, planes(0, 4), planes(0, 40), self_inc, mid),
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _equal(got, want, what):
    got, want = _outs(got), _outs(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i, g.dtype, w.dtype)
        assert torch.equal(g, w), "%s: output %d differs" % (what, i)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1024, K), (1000, K), (45, K), (1000, 19), (45, 45)])
@pytest.mark.parametrize("need,respond", [(0.02, 0.9), (1.0, 0.5), (1.0, 1.0)])
def test_kernels_equal_plain_on_card(cuda_device, n, k, need, respond):
    """Each kernel against its plain version, batched (one launch for
    four clusters) and alone, with rows needing no ping-req, rows with
    no candidate, and every slot answering; K above the select's eight
    keys a pass, up to every column."""
    b = 4
    args = _phase_inputs(b, n, n + k + int(need * 10), cuda_device, need=need, respond=respond,
                         k=k)
    args["ping_req_select"][0][0, :5] = False  # rows with no candidate
    for name, a in args.items():
        wrapper = getattr(prk, name)
        before = wrapper.launches
        got = vmap(_piece(name, k=k))(*a)
        assert wrapper.launches - before == 1, name
        for i in range(b):
            want = _piece(name, plain=True, k=k)(*(x[i] for x in a))
            _equal(tuple(g[i] for g in _outs(got)), want, "%s n=%d K=%d cluster %d batched"
                   % (name, n, k, i))
            _equal(_piece(name, k=k)(*(x[i] for x in a)), want,
                   "%s n=%d K=%d cluster %d" % (name, n, k, i))


CARD_CASES = {
    "pulse": dict(n=1024, sched=lambda n: _pulse(n, 40, first=5, every=10, kills=5,
                                                 revive_after=20)),
    "partition": dict(n=256, sched=lambda n: _partitioned(n, 16, heal_at=12)),
    "loss-0.05": dict(n=256, sched=lambda n: _pulse(n, 16), packet_loss=0.05),
    "loss-0.5": dict(n=256, sched=lambda n: EventSchedule(ticks=12, n=n), packet_loss=0.5),
    "n1000": dict(n=1000, sched=lambda n: _pulse(n, 16, kills=5)),
    "planes": dict(n=256, sched=lambda n: _pulse(n, 16), flight_recorder=True, histograms=True,
                   packet_loss=0.05),
    "k-19": dict(n=256, sched=lambda n: _pulse(n, 12), packet_loss=0.3, ping_req_size=19),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case,b", [(c, b) for c in sorted(CARD_CASES) for b in (None, 1, 4)]
                         + [("pulse", 32)])
def test_engine_kernels_equal_plain_phase_on_card(cuda_device, monkeypatch, case, b):
    """The tick with the phase's kernels against the tick with the plain
    phase (every other kernel the same), every state field (the flight
    recorder's and the histograms' planes among them) and metric every
    tick; B = 32 for the b32 pulse."""
    kw = dict(CARD_CASES[case])
    n = kw.pop("n")
    sched = kw.pop("sched")(n)
    before = prk.ping_req_combine.launches
    prs = _assert_routes_equal(monkeypatch, n, sched, "%s b=%s" % (case, b), b=b,
                               device=cuda_device, **kw)
    assert prs > 0 and prk.ping_req_combine.launches > before
