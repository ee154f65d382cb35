"""The ``overflow`` prong of the port's analysis: the allowlist matcher equal
to JAX's; the triaged ``ALLOWED`` table's classes against JAX's; one
mutation per rule; the ``UINT32_FIELDS`` registries equal to the fields
JAX's states hold as uint32; and the launch-side half of
``index-overflow``: ``KernelLibrary.call`` refuses an integer argument
outside int32 before ``ctypes`` would truncate it.

The whole-tree run (0 findings, no stale row) is in
tests/test_torch_analysis_cli.py."""

from __future__ import annotations

import ctypes
import re

import jax
import numpy as np
import pytest
import torch

from ringpop_tpu.analysis import jaxpr_audit as jja
from ringpop_tpu.analysis import overflow as jof
from ringpop_tpu.models.route import plane as jplane
from ringpop_tpu.models.sim import engine as jengine
from ringpop_tpu.models.sim import engine_scalable as jes
from ringpop_tpu_torch.analysis import graph_audit as ga
from ringpop_tpu_torch.analysis import overflow as of
from ringpop_tpu_torch.analysis import ranges
from ringpop_tpu_torch.ops import _build
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _names(seed):
    rng = np.random.default_rng(seed)
    alphabet = list("abc-.[]*0123:@/_")
    return ["".join(rng.choice(alphabet, rng.integers(1, 9))) for _ in range(60)]


@pytest.mark.parametrize("seed", range(3))
def test_matcher_equals_jax(seed):
    values = _names(seed)
    patterns = [p for p in _names(seed + 10) if p] + ["unbounded-carry:carry[*]", "*", "a*c"]
    for v in values + ["unbounded-carry:carry[0]", "a.c", "abc"]:
        for p in patterns:
            assert of._match(v, (p,)) == jof._match(v, (p,)), (v, p)


def test_allowed_returns_the_first_matching_row_as_jax():
    rows = (of.AllowRow(("e-*",), ("r:k1",), "one"), of.AllowRow(("*",), ("r:*",), "two"))
    jrows = tuple(jof.AllowRow(r.entries, r.keys, r.why) for r in rows)
    for case in (("e-x", "r", "k1"), ("other", "r", "k9"), ("other", "q", "k9")):
        assert of.allowed(*case, allowlist=rows) == jof.allowed(*case, allowlist=jrows)


def test_every_row_documents_why():
    for row in of.ALLOWED:
        assert len(row.why) > 40 and row.entries and row.keys, row
    for pat, why in ranges.WRAP_CONTRACT.items():
        assert len(why) > 40, pat


def _carry_fields(rows):
    return {k.split(":", 1)[1] for row in rows for k in row.keys
            if k.startswith("unbounded-carry:") and "carry[" not in k}


# JAX's triaged carry fields the port's recordings prove bounded, and the
# port's that JAX's entries never showed, each with its reason
JAX_ONLY = {
    "ScalableState.defame_by": (
        "representative accuser ids: the port's recording keeps them in the node ids "
        "the tick computes, [-1, N); JAX's jaxpr walk widened them through selects"
    ),
}
PORT_ONLY = {
    "ScalableState.first_heard": "the wavefront's stamps: an obs-only plane (JAX's class)",
    "RouteState.req_buf": "request-trace plane: JAX's route entries are one tick, no carry",
    "RouteState.req_tick": "request-trace plane: JAX's route entries are one tick, no carry",
    "RouteState.req_drops": "request-trace plane: JAX's route entries are one tick, no carry",
    "RouteState.req_counts": "request-trace plane: JAX's route entries are one tick, no carry",
    "RouteState.ring.first_owner": "the bucketed ring's owners: one-tick route entries in JAX",
    "RouteState.ring.next_owner": "the bucketed ring's owners: one-tick route entries in JAX",
}


def test_allowed_carry_fields_match_jax_classes():
    port, jax_fields = _carry_fields(of.ALLOWED), _carry_fields(jof.ALLOWED)
    assert jax_fields - port == set(JAX_ONLY)
    assert port - jax_fields == set(PORT_ONLY)
    # JAX's dtype-overflow classes stand here by their port sites
    port_keys = {k for row in of.ALLOWED for k in row.keys}
    assert "dtype-overflow:mul@models/sim/engine.py:_pack_key" in port_keys
    assert any(k.startswith("dtype-overflow:sum.scaled@") for k in port_keys)
    assert {k for row in jof.ALLOWED for k in row.keys if k.startswith("dtype")} == {
        "dtype-overflow:mul.out0", "dtype-overflow:reduce_sum.scaled.*"}


def _jax_u32_fields(state):
    return {f for f, v in zip(state._fields, state)
            if getattr(v, "dtype", None) == np.uint32}


def test_uint32_fields_equal_jax_states():
    # every plane on; the dtypes alone (jax.eval_shape) for the two engines
    st = jax.eval_shape(lambda: jengine.init_state(
        jengine.SimParams(n=8, checksum_mode="fast", flight_recorder=True, histograms=True),
        seed=0))
    ss = jax.eval_shape(lambda: jes.init_state(
        jes.ScalableParams(n=8, u=128, wavefront=True, histograms=True, exchange_metrics=4),
        seed=0))
    rs = jja._route_fixture("incremental", histograms=True)[5]
    want = {
        "SimState": _jax_u32_fields(st),
        "ScalableState": _jax_u32_fields(ss),
        "RouteState": _jax_u32_fields(rs),
    }
    assert {k: set(v) for k, v in ranges.uint32_fields().items()} == want
    assert set(jplane.RouteState._fields) >= want["RouteState"]


# -- one mutation per rule (the prong's own entry points) ---------------------


def test_seeded_per_tick_counter_is_an_unbounded_carry():
    fn, args = ga._entry_scalable_tick()

    def doctored(state, inputs):
        st, m = fn(state, inputs)
        return st._replace(partition=st.partition + 1), m

    found, _ = of.check_entry("engine-scalable-tick", doctored, args)
    assert any(f.rule == "unbounded-carry" and "ScalableState.partition" in f.message
               for f in found), found
    clean, _ = of.check_entry("engine-scalable-tick", fn, args)
    assert not clean


def test_int32_sum_over_an_n_axis_overflows_at_the_declared_n():
    x = torch.ones(8, 8, dtype=torch.int32)
    found, _ = of.check_entry("fused-apply-doctored", lambda t: t.sum(dtype=torch.int32), (x,),
                              allowlist=())
    assert [f.rule for f in found] == ["dtype-overflow"]
    assert "sum.scaled" in found[0].message


def test_int32_arange_of_a_scaled_extent_is_an_index_overflow():
    spec = ranges.ScaleSpec(8, ranges.N_MAX_PODS, coeffs=(1, 100))
    found, _ = of.check_entry(
        "doctored", lambda t: torch.arange(t.shape[0] * 100, dtype=torch.int32) + t.sum(),
        (torch.zeros(8, dtype=torch.int32),), spec=spec)
    assert [f.rule for f in found] == ["index-overflow"]


def test_a_row_that_matches_nothing_is_stale(monkeypatch):
    ep = ga.EntryPoint("doctored", lambda: ((lambda t: t + 1), (torch.zeros(8, dtype=torch.int32),)))
    monkeypatch.setattr(ga, "DEFAULT_ENTRIES", [ep])
    monkeypatch.setattr(ga, "ENTRIES_BY_NAME", {ep.name: ep})
    monkeypatch.setattr(ga, "_TRACE_CACHE", {})
    bogus = of.AllowRow(("*",), ("dtype-overflow:nothing@nowhere",), "x" * 50)
    found = of.check_overflow(allowlist=(bogus,), wrap={"ops/nowhere.py:*": "y" * 50})
    assert sorted(f.rule for f in found) == ["stale-allowlist", "stale-allowlist"]
    assert any("ALLOWED[0]" in f.message for f in found)
    assert any("WRAP_CONTRACT" in f.message for f in found)


def test_entries_for_changed_scopes_to_recorded_trees():
    assert of.entries_for_changed(["obs/slo.py"]) == []
    assert len(of.entries_for_changed(["ops/u32.py"])) == len(ga.DEFAULT_ENTRIES)


# -- the launch side: a kernel's int argument outside int32 -------------------


class _StubLibrary(_build.KernelLibrary):
    """A kernel library with one stub entry and no shared object."""

    def __init__(self):
        self.launched = []

        def stub(table, *args):
            self.launched.append(args)
            return 0

        self._entry = {"stub": (stub, ctypes.c_void_p * 2)}


def test_ctypes_truncates_an_int_past_int32_silently():
    assert ctypes.c_int((1 << 32) + 7).value == 7


@pytest.mark.parametrize("bad", [(1 << 32) + 7, 1 << 31, -(1 << 31) - 1])
def test_kernel_call_raises_on_an_int_outside_int32(bad, monkeypatch):
    lib = _StubLibrary()
    monkeypatch.setattr(_build, "_current_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    with pytest.raises(OverflowError, match=re.escape(str(bad))):
        lib.call("stub", torch.device("cpu"), (0, 0), 5, bad)
    assert lib.launched == []
    lib.call("stub", torch.device("cpu"), (0, 0), 5, (1 << 31) - 1, -(1 << 31))
    assert lib.launched == [(5, (1 << 31) - 1, -(1 << 31), 0)]


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
