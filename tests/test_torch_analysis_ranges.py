"""The port's interval interpreter (``ringpop_tpu_torch/analysis/ranges.py``):
its copy of JAX's interval algebra, widening, constants and scale model held
equal to ``ringpop_tpu/analysis/ranges.py`` on seeded random intervals with
±∞ endpoints, and its transfer functions over small recorded functions.

JAX's own ``analyze_jaxpr`` and ``buffer_poly`` are not run: on jax 0.9.0
they raise (``jax.core.Literal`` is gone)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu.analysis import ranges as jr
from ringpop_tpu_torch.analysis import dataflow, graph_audit as ga
from ringpop_tpu_torch.analysis import ranges as pr
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

BINARY = ["union", "widen", "iv_add", "iv_sub", "iv_mul", "iv_min", "iv_max", "iv_div",
          "iv_rem", "iv_and", "iv_orxor", "iv_shl", "iv_shr"]
UNARY = ["iv_neg", "iv_abs"]


def _random_intervals(seed: int, count: int = 300):
    rng = np.random.default_rng(seed)
    edges = [None, 0, 1, -1, -2, 255, 65535, 1 << 20, -(1 << 20), (1 << 31) - 1, -(1 << 31),
             (1 << 32) - 1, 7, 64]
    out = [None]
    for _ in range(count):
        if rng.random() < 0.4:
            lo, hi = rng.choice(len(edges), 2)
            lo, hi = edges[lo], edges[hi]
        else:
            lo, hi = (int(v) for v in rng.integers(-2000, 2000, 2))
        if lo is not None and hi is not None and lo > hi:
            lo, hi = hi, lo
        out.append((lo, hi))
    return out


def _pair(v):
    return None if v is None else (v.lo, v.hi)


def _both(t):
    if t is None:
        return None, None
    return pr.Interval(*t), jr.Interval(*t)


@pytest.mark.parametrize("name", BINARY + UNARY)
def test_interval_algebra_equals_jax(name):
    ivs = _random_intervals(BINARY.index(name) if name in BINARY else 50 + UNARY.index(name))
    rng = np.random.default_rng(7)
    pf, jf = getattr(pr, name), getattr(jr, name)
    for k in range(len(ivs)):
        pa, ja = _both(ivs[k])
        if name in UNARY:
            assert _pair(pf(pa)) == _pair(jf(ja)), (name, ivs[k])
            continue
        other = ivs[int(rng.integers(len(ivs)))]
        if name in ("iv_shl", "iv_shr") and other is not None:
            other = tuple(None if v is None else abs(v) % 70 for v in other)
            if None not in other and other[0] > other[1]:
                other = (other[1], other[0])
        pb, jb = _both(other)
        assert _pair(pf(pa, pb)) == _pair(jf(ja, jb)), (name, ivs[k], other)


def test_widen_walks_the_same_landmark_ladder():
    for start in [(0, 0), (-1, 3), (5, 5), (None, 0), (-(1 << 20), 1 << 20)]:
        pc, jc = _both(start)
        for _ in range(len(pr._HI_LANDMARKS) + 2):
            pc = pr.widen(pc, pr.iv_sub(pr.iv_add(pc, pr.point(1)), pr.point(3)))
            jc = jr.widen(jc, jr.iv_sub(jr.iv_add(jc, jr.point(1)), jr.point(3)))
            assert _pair(pc) == _pair(jc), start
    assert pr.widen(pr.Interval(0, 5), pr.Interval(0, 6)) == pr.Interval(0, (1 << 8) - 1)


def test_constants_equal_jax():
    for name in ("TICK_CEILING", "N_MAX_PODS", "FULL_N_MAX", "ROUTE_N_MAX", "HASH_ROWS_MAX",
                 "U_ENVELOPE", "SENTINEL_LO", "_HI_LANDMARKS", "_LO_LANDMARKS",
                 "_SCALABLE_DIMS"):
        assert getattr(pr, name) == getattr(jr, name), name
    assert (pr.FULL.lo, pr.FULL.hi) == (jr.FULL.lo, jr.FULL.hi)
    assert (pr.BOOL.lo, pr.BOOL.hi) == (jr.BOOL.lo, jr.BOOL.hi)


@pytest.mark.parametrize("dt", ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
                                "uint64", "bool", "float32"])
def test_dtype_interval_equals_jax(dt):
    want = jr.dtype_interval(np.dtype(dt))
    got = pr.dtype_interval(getattr(torch, dt))
    assert _pair(got) == _pair(want)
    assert _pair(pr.dtype_interval("torch." + dt)) == _pair(want)


def test_scaled_dim_on_the_envelopes_equals_jax():
    for kw in (dict(), dict(coeffs=(1, 100)), dict(dim_map=jr._SCALABLE_DIMS),
               dict(n_max=pr.FULL_N_MAX), dict(n_max=pr.ROUTE_N_MAX, coeffs=(1, 100)),
               dict(n_max=pr.HASH_ROWS_MAX, dim_map=((8, 99),))):
        pspec, jspec = pr.ScaleSpec(**kw), jr.ScaleSpec(**kw)
        for d in (1, 4, 7, 8, 16, 32, 64, 128, 800, 801, 1024):
            assert pr._dim_rule(d, pspec) == jr._dim_rule(d, jspec), (kw, d)
            assert pr.scaled_dim(d, pspec) == jr.scaled_dim(d, jspec), (kw, d)


def test_entry_scales_match_jax_counterparts():
    """Each port entry prices its dims as its JAX counterpart does (same
    ceiling and coefficients; the scalable pins), apart from the hash
    entries' width pins, which JAX's 8-row toys never needed."""
    for jname, pname in ga.JAX_ENTRY_COUNTERPARTS.items():
        js, ps = jr.entry_scale(jname), pr.entry_scale(pname)
        assert (ps.toy_n, ps.n_max, ps.coeffs) == (js.toy_n, js.n_max, js.coeffs), jname
        if pname.startswith(("farmhash-", "fused-stream-", "block-loop-")):
            assert ps.dim_map == pr._HASH_DIMS
        else:
            assert ps.dim_map == js.dim_map, jname


@pytest.mark.parametrize("seed", range(4))
def test_poly_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        poly = {int(e): int(c) for e, c in zip(rng.choice(4, rng.integers(1, 4), replace=False),
                                               rng.integers(1, 10**6, 3))}
        budget = int(rng.integers(10**6, 10**12))
        n_max = int(rng.choice([1 << 16, 1 << 20, 64 << 20]))
        for n in (1, 8, 1024, 1 << 20):
            assert pr.poly_bytes(poly, n) == jr.poly_bytes(poly, n)
        assert pr.feasible_n(poly, budget, n_max) == jr.feasible_n(poly, budget, n_max)


# -- the interpreter over recorded functions (the port's own) ----------------


def _events(fn, args, spec=None, names=None, out_names=None):
    rec = dataflow.record(fn, args, detail=True)
    evs, _ = pr.analyze(rec, spec or pr.ScaleSpec(), names, out_names)
    return rec, {(e.rule, e.key.split("@")[0]) for e in evs}


def test_transfer_keeps_contract_ranges_and_reports_escapes():
    x = torch.arange(64, dtype=torch.int32).reshape(8, 8)
    # [-2, 2^20] inputs: + 2 fits, a shift by 12 escapes int32 from tame inputs
    _, evs = _events(lambda t: (t + 2) << 12, (x,))
    assert ("dtype-overflow", "bitwise_left_shift") in evs
    _, evs = _events(lambda t: (t + 1).clamp(max=5) * 3, (x,))
    assert not evs


def test_sum_is_repriced_at_the_declared_n():
    x = torch.ones(8, 8, dtype=torch.int32)
    _, evs = _events(lambda t: t.sum(dtype=torch.int32), (x,), pr.ScaleSpec(8, pr.FULL_N_MAX))
    assert ("dtype-overflow", "sum.scaled") in evs
    # the same sum over constant dims stays silent
    _, evs = _events(lambda t: t.sum(dtype=torch.int32), (torch.ones(3, 5, dtype=torch.int32),),
                     pr.ScaleSpec(8, pr.FULL_N_MAX))
    assert not evs


def test_index_lanes_at_the_declared_ceiling():
    spec = pr.ScaleSpec(8, pr.N_MAX_PODS, coeffs=(1, 100))
    _, evs = _events(lambda t: torch.arange(t.shape[0] * 100, dtype=torch.int32) + t.sum(),
                     (torch.zeros(8, dtype=torch.int32),), spec)
    assert ("index-overflow", "arange") in evs

    def flat(t):  # an int32 flat offset row * n + col
        r = torch.arange(t.shape[0])
        return (r[:, None] * t.shape[0] + r[None, :]).to(torch.int32)

    _, evs = _events(flat, (torch.zeros(8),), pr.ScaleSpec(8, pr.FULL_N_MAX))
    assert ("index-overflow", "_to_copy.scaled") in evs
    _, evs = _events(flat, (torch.zeros(8),), pr.ScaleSpec(8, 1 << 12))
    assert not evs


def test_empty_is_bottom_and_where_joins_its_arms():
    def fn(t):
        out = torch.empty(8, dtype=torch.int32)
        out.copy_(t.clamp(0, 9))
        return torch.where(t > 3, out, torch.full_like(out, -1))

    rec = dataflow.record(fn, (torch.arange(8, dtype=torch.int32),), detail=True)
    interp = pr.RangeInterpreter(rec)
    (out,) = interp.run([pr.Interval(-2, 1 << 20)])
    assert out == pr.Interval(-1, 9)


def test_uint32_fields_seed_full_range_and_signed_carries_widen():
    """A registered state's uint32 lanes are seeded with the whole int32
    range, and a signed field growing by one a tick is an unbounded carry."""
    from ringpop_tpu_torch.models.sim import engine_scalable as es

    params = es.resolve_scalable_params(es.ScalableParams(n=8, u=128), "cpu")
    state = es.init_state(params, seed=0, device="cpu")

    def tick(s):
        return s._replace(partition=s.partition + 1, checksum=s.checksum * 3)

    rec = dataflow.record(tick, (state,), detail=True)
    ins, outs = pr.leaf_names(rec, (state,))
    seeds = pr.contract_seeds(rec, ins)
    assert seeds[ins.index("ScalableState.checksum")] == pr.dtype_interval(torch.int32)
    evs, _ = pr.analyze(rec, pr.entry_scale("engine-scalable-tick"), ins, outs)
    assert {(e.rule, e.key) for e in evs} == {("unbounded-carry", "ScalableState.partition")}
