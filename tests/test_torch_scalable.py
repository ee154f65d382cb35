"""The port's scalable engine against the JAX engine, tick by tick, bit for bit.

Both engines start from one state (the JAX ``ScalableState`` carried across
by ``ringpop_tpu_torch.convert``) and take the same per-tick inputs, made
with numpy from a seed:

- ``storm``: a 10% churn storm (kill at tick 2, revive at tick 20) under
  5% packet loss, so indirect rounds, false suspects and refutes fire,
  plus a partition split at tick 5 healed at tick 14;
- ``leave``: graceful leaves and crashes at tick 2, all back at tick 20
  (``enable_leave=True``).

Every ``ScalableState`` field (dtype pinned) and every ``ScalableMetrics``
field must be equal on every tick, ``mean_heard_frac`` (a float32 mean)
included: the port sums it in the order XLA's CPU backend does
(``engine_scalable._xla_mean_f32``).  The port also keeps its
incremental checksum equal to the full recompute on every tick.  The JAX
side compiles once per parameter tuple, so the combinations are chosen
sparingly; the JAX package's own tests already hold its gate, perm and
fused-exchange settings to one trajectory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models.sim import engine_scalable as pes
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

TICKS = 40

_DTYPES = {
    "proc_alive": torch.bool, "gossip_on": torch.bool, "r_active": torch.bool,
}


def _key(a, b):
    return jnp.asarray(np.array([a, b], np.uint32))


def _pkey(a, b):
    return torch.as_tensor(np.array([a, b], np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# the pieces


@pytest.mark.parametrize("n", [8, 64, 100, 1000])
def test_prp_perm_and_inverse_equal_jax(n):
    for a, b in ((0x12345678, 0x9ABCDEF0), (7, 0xFFFFFFFE)):
        for inverse in (False, True):
            want = np.asarray(jes._prp_perm(_key(a, b), n, 0xA11CE, inverse=inverse))
            got = pes._prp_perm(_pkey(a, b), n, 0xA11CE, inverse=inverse)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want), (n, inverse)
        fwd, inv = pes._base_perm_pair(_pkey(a, b), n, "argsort", 0xA11CE)
        assert np.array_equal(inv.numpy(), np.asarray(jes._prp_perm(_key(a, b), n, 0xA11CE, True)))
        assert np.array_equal(fwd.numpy()[inv.numpy()], np.arange(n))


def test_rng_pieces_equal_jax():
    """Keys and values >= 2^31: every right shift of a uint32 must be
    logical (``u32.srl``) and uint32 -> float32 must round like XLA."""
    k = (0xDEADBEEF, 0x80000001)
    want = np.asarray(jes._rand_u32(_key(*k), (3, 5), 0xB0B1))
    got = pes._rand_u32(_pkey(*k), (3, 5), 0xB0B1)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    u = pes._uniform(_pkey(*k), (1000,), 0xD0DE)
    assert u.dtype == torch.float32
    assert np.array_equal(u.numpy(), np.asarray(jes._uniform(_key(*k), (1000,), 0xD0DE)))
    assert np.array_equal(
        pes._fold(_pkey(*k), 0x5CA1E).numpy().view(np.uint32),
        np.asarray(jes._fold(_key(*k), 0x5CA1E)),
    )
    bits = np.random.default_rng(1).random(96) < 0.5
    assert np.array_equal(
        pes._pack_mask(torch.as_tensor(bits)).numpy().view(np.uint32),
        np.asarray(jes._pack_mask(jnp.asarray(bits))),
    )


def test_drop_mode_scatters_equal_jax():
    """JAX drops out-of-range scatter indices (``mode="drop"``); the port
    scatters into n + 1 slots and slices the last off."""
    n = 50
    rng = np.random.default_rng(8)
    accuser = rng.random(n) < 0.4
    subj = np.where(accuser, rng.integers(0, n, n), n).astype(np.int32)
    part = rng.integers(0, 2, n).astype(np.int32)
    want_mask = np.asarray(jnp.zeros(n, bool).at[jnp.asarray(subj)].set(True, mode="drop"))
    solo = pes.Solo(n)
    got_mask = pes.run_solo(pes._shard_subject_mask(solo, torch.as_tensor(subj), n))
    assert np.array_equal(got_mask.numpy(), want_mask)
    want = np.asarray(jes._representative_accuser(
        jnp.asarray(accuser), jnp.asarray(subj), jnp.asarray(part), n))
    ids = torch.arange(n, dtype=torch.int32)
    part_t = torch.as_tensor(part)
    got = pes.run_solo(pes._shard_accuser(
        solo, ids, torch.as_tensor(accuser), torch.as_tensor(subj), part_t, part_t, n))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy()[want_mask], want[want_mask])
    assert np.array_equal(got.numpy(), want)


def test_bit_delta_sum_ignores_the_tf32_switch():
    """The JAX engine's limb matmul is exact only in full float32; the
    port's delta sum is integer arithmetic, so the process-wide TF32 switch
    cannot change it.  Deltas near 2^32 would lose bits in any float."""
    n, w = 40, 4
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF
    delta = (0xFFFFFFFF - rng.integers(0, 4, w * 32)).astype(np.uint32)
    want = np.asarray(jes._bit_delta_sum(jnp.asarray(words), jnp.asarray(delta), w * 32))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        got = pes._bit_delta_sum(torch.as_tensor(words.view(np.int32)),
                                 torch.as_tensor(delta.view(np.int32)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_resolvers_and_unported_planes():
    p = pes.ScalableParams(n=8)
    assert pes.resolve_fused_exchange(p, "cuda") == "kernel"
    assert pes.resolve_fused_exchange(p, "cpu") == "plain"
    assert pes.resolve_fused_exchange(p._replace(fused_exchange="off"), "cuda") == "off"
    assert pes.resolve_perm_impl(p) == "sortless"
    pinned = pes.resolve_scalable_params(p, "cpu")
    assert (pinned.perm_impl, pinned.fused_exchange) == ("sortless", "plain")
    with pytest.raises(ValueError):
        pes.resolve_fused_exchange(p._replace(fused_exchange="xla"), "cpu")
    with pytest.raises(ValueError):
        pes.resolve_perm_impl(p._replace(perm_impl="bogus"))
    # the obs planes are ported: each one initializes its own field
    for plane, field in ((dict(wavefront=True), "first_heard"), (dict(histograms=True), "hist"),
                         (dict(exchange_metrics=2), "exch")):
        st = pes.init_state(pes.ScalableParams(n=64, u=160, **plane), device="cpu")
        assert getattr(st, field) is not None, plane
    with pytest.raises(ValueError, match="divisor"):
        pes.init_state(pes.ScalableParams(n=64, u=160, exchange_metrics=3), device="cpu")
    st = pes.init_state(pes.ScalableParams(n=64, u=160), device="cpu")
    # the exchange_plane seam is ported: a one-shard plane gives the inline tick
    from ringpop_tpu_torch.parallel import mesh as pmesh

    p64 = pes.ScalableParams(n=64, u=160, packet_loss=0.3)
    plane = pmesh.make_exchange_plane(pmesh.make_mesh(1, device="cpu"), "plain", n=64)
    want = pes.tick(st, pes.ChurnInputs.quiet(64), p64)
    got = pes.tick(st, pes.ChurnInputs.quiet(64), p64, exchange_plane=plane)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="enable_leave"):
        pes.tick(st, pes.ChurnInputs.quiet(64)._replace(leave=torch.zeros(64, dtype=torch.bool)),
                 pes.ScalableParams(n=64, u=160))
    with pytest.raises(ValueError, match="recycle"):
        pes.init_state(pes.ScalableParams(n=64, u=64), device="cpu")


# ---------------------------------------------------------------------------
# whole trajectories


def _jax_params(kind, n, gate=True, perm="sortless", fused="xla"):
    kw = dict(n=n, u=192, suspicion_ticks=4, gate_phases=gate, perm_impl=perm,
              fused_exchange=fused)
    if kind == "storm":
        kw["packet_loss"] = 0.05
    else:
        kw.update(enable_leave=True, u=256)
    return jes.ScalableParams(**kw)


def _events(kind, n):
    """Per-tick input dicts (numpy) of one schedule."""
    rng = np.random.default_rng(n)
    victims = rng.choice(n, size=max(1, n // 10), replace=False)
    evs = []
    for t in range(TICKS):
        ev = dict(kill=np.zeros(n, bool), revive=np.zeros(n, bool))
        if kind == "storm":
            ev["kill"][victims] = t == 2
            ev["revive"][victims] = t == 20
            if t in (5, 14):
                part = np.zeros(n, np.int32)
                if t == 5:
                    part[n // 2:] = 1
                ev["partition"] = part
        else:
            ev["leave"] = np.zeros(n, bool)
            ev["leave"][:6] = t == 2
            ev["kill"][10:13] = t == 2
            ev["revive"][:6] = t == 20
            ev["revive"][10:13] = t == 20
        evs.append(ev)
    return evs


def _state_np(js):
    return {f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
            for f in jes.ScalableState._fields}


@functools.lru_cache(maxsize=None)
def _jax_trajectory(kind, n, gate, perm, fused):
    """(initial state, [(state, metrics)] per tick) as numpy, cached per
    parameter tuple: every port combination reuses one JAX run."""
    params = _jax_params(kind, n, gate, perm, fused)
    st = jes.init_state(params, seed=n + 1)
    step = jax.jit(functools.partial(jes.tick, params=params))
    out = []
    init = _state_np(st)
    for ev in _events(kind, n):
        st, m = step(st, jes.ChurnInputs(**{k: jnp.asarray(v) for k, v in ev.items()}))
        out.append((_state_np(st), {f: np.asarray(getattr(m, f)) for f in m._fields}))
    return init, out


def _assert_state(want, ps, label):
    got = convert.scalable_state_to_numpy(ps)
    for f in pes.ScalableState._fields:
        if want[f] is None:
            assert got[f] is None, (label, f)
            continue
        assert got[f].shape == want[f].shape, (label, f)
        assert np.array_equal(got[f], want[f]), "%s: state field %s differs" % (label, f)
        assert getattr(ps, f).dtype == _DTYPES.get(f, torch.int32), (label, f)


def _assert_metrics(want, pm, label):
    for f in pes.ScalableMetrics._fields:
        got = getattr(pm, f)
        assert got.shape == (), (label, f)
        if f == "mean_heard_frac":
            assert got.dtype == torch.float32
            assert got.numpy().view(np.uint32) == np.asarray(want[f], np.float32).view(np.uint32), (
                "%s: mean_heard_frac %r vs %r" % (label, got.item(), want[f]))
        else:
            assert got.dtype == (torch.bool if f == "full_coverage" else torch.int32), (label, f)
            assert got.item() == want[f].item(), "%s: metric %s: %r vs %r" % (
                label, f, got.item(), want[f].item())


def _run_port(kind, n, gate, perm, fused, jax_fused):
    init, traj = _jax_trajectory(kind, n, gate, perm, jax_fused)
    pp = convert.scalable_params_from_jax_fields(
        _jax_params(kind, n, gate, perm, jax_fused)._asdict()
    )._replace(fused_exchange=fused)
    ps = convert.scalable_state_from_numpy(init)
    _assert_state(init, ps, "init")
    fired = dict.fromkeys(("suspects_published", "faulties_published", "refutes_published",
                           "leaves_published", "ping_req_inconclusive"), 0)
    for t, (ev, (want_s, want_m)) in enumerate(zip(_events(kind, n), traj)):
        inputs = pes.ChurnInputs(**{k: torch.as_tensor(v) for k, v in ev.items()})
        ps, pm = pes.tick(ps, inputs, pp)
        label = "%s n=%d %s tick %d" % (kind, n, (gate, perm, fused), t)
        _assert_state(want_s, ps, label)
        _assert_metrics(want_m, pm, label)
        assert torch.equal(ps.checksum, pes.compute_checksums(ps, pp)), label
        for f in fired:
            fired[f] += int(getattr(pm, f))
    return fired


# port fused "plain" and "kernel" (which runs plain on CPU tensors) are held
# against the JAX op twin, port "off" against JAX "off"
_COMBOS = [
    ("storm", 64, gate, perm, fused)
    for gate in (True, False)
    for perm in ("sortless", "argsort")
    for fused in ("plain", "off")
] + [
    ("storm", 100, True, "sortless", "kernel"),
    ("storm", 100, False, "argsort", "off"),
    ("leave", 64, True, "sortless", "plain"),
    ("leave", 64, False, "sortless", "off"),
]


@pytest.mark.parametrize("kind,n,gate,perm,fused", _COMBOS)
def test_tick_bitwise_equal_to_jax_every_tick(kind, n, gate, perm, fused):
    jax_fused = "off" if fused == "off" else "xla"
    fired = _run_port(kind, n, gate, perm, fused, jax_fused)
    if kind == "storm":
        for f in ("suspects_published", "faulties_published", "refutes_published",
                  "ping_req_inconclusive"):
            assert fired[f] > 0, "the storm must exercise %s" % f
    else:
        assert fired["leaves_published"] == 6


def test_jax_settings_share_one_trajectory():
    """The references themselves: the JAX engine's op twin and inline
    phases give one trajectory (what lets port combinations share them)."""
    a = _jax_trajectory("storm", 64, True, "sortless", "xla")
    b = _jax_trajectory("storm", 64, True, "sortless", "off")
    for (sa, ma), (sb, mb) in zip(a[1], b[1]):
        for f in sa:
            assert (sa[f] is None and sb[f] is None) or np.array_equal(sa[f], sb[f]), f
        for f in ma:
            assert np.array_equal(ma[f], mb[f]), f


def test_init_state_equals_jax():
    for kind in ("storm", "leave"):
        jp = _jax_params(kind, 100)
        pp = convert.scalable_params_from_jax_fields(jp._asdict())
        _assert_state(_state_np(jes.init_state(jp, seed=4)), pes.init_state(pp, seed=4, device="cpu"),
                      kind)


def test_host_reads_per_tick():
    """Gated phases and the PRP cycle walk read device predicates on the
    host; straight-line phases leave only the walk's reads."""
    n = 100
    counts = {}
    for gate in (True, False):
        p = pes.ScalableParams(n=n, u=192, gate_phases=gate)
        st = pes.init_state(p, seed=1, device="cpu")
        before = pes.host_read.count
        st, _ = pes.tick(st, pes.ChurnInputs.quiet(n), p)
        counts[gate] = pes.host_read.count - before
    # two walks (forward, inverse) of at least one read each; a gated
    # quiet tick adds retire, indirect, diff, 3 publishes, coverage, distinct
    assert counts[False] >= 2
    assert counts[True] == counts[False] + 8
