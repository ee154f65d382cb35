"""The ``graph`` prong of the port's analysis: every registered entry is
clean on the tree; the straight-line and batched ticks record no host
read and a gated tick exactly the reads its body yields; seeded mutations
fire ``host-sync`` and ``wide-dtype-on-hash-path``; every JAX entry point
has a counterpart."""

from __future__ import annotations

import pytest
import torch

from ringpop_tpu.analysis import jaxpr_audit as ja
from ringpop_tpu_torch.analysis import dataflow
from ringpop_tpu_torch.analysis import graph_audit as ga
from ringpop_tpu_torch.analysis.findings import render_text
from ringpop_tpu_torch.models.sim import engine_scalable as es
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


@pytest.mark.parametrize("name", [ep.name for ep in ga.DEFAULT_ENTRIES])
def test_entry_is_clean(name):
    findings = ga.audit_entries([ga.ENTRIES_BY_NAME[name]])
    assert findings == [], "\n" + render_text(findings)


def test_every_jax_entry_has_a_counterpart():
    jax_names = {ep.name for ep in ja.DEFAULT_ENTRIES}
    assert len(jax_names) == 34
    assert set(ga.JAX_ENTRY_COUNTERPARTS) == jax_names
    for jax_name, port in ga.JAX_ENTRY_COUNTERPARTS.items():
        assert port.startswith("none:") or port in ga.ENTRIES_BY_NAME, (jax_name, port)


@pytest.mark.parametrize("name", ["engine-tick-straight", "engine-tick-straight-fast",
                                  "batched-tick"])
def test_straight_line_and_batched_ticks_read_nothing(name):
    r = ga.recorded(ga.ENTRIES_BY_NAME[name])
    assert r.declared == 0
    assert r.recording.host_reads == []
    assert len(r.recording.ops) > 1000  # the whole tick ran under the recorder


@pytest.mark.parametrize("name", ["engine-tick", "engine-tick-fused"])
def test_gated_tick_reads_exactly_its_yields(name):
    """Every recorded read is one the body yielded (``pred`` or ``counts``,
    answered by run_solo): the counts agree read for read."""
    ep = ga.ENTRIES_BY_NAME[name]
    fn, args = ep.build()
    yields = []
    real = es.run_solo

    def counting(body):
        def wrapped():
            reply = None
            while True:
                try:
                    op, x = body.send(reply)
                except StopIteration as stop:
                    return stop.value
                if op in ("pred", "counts"):
                    yields.append(op)
                reply = yield op, x
        return real(wrapped())

    from ringpop_tpu_torch.models.sim import engine

    orig = engine.run_solo
    engine.run_solo = counting
    try:
        rec = dataflow.record(fn, args)
    finally:
        engine.run_solo = orig
    reads = [op for op in rec.host_reads]
    assert len(yields) > 0 and "pred" in yields
    assert len(reads) == len(yields)
    assert all(op.name == dataflow.LOCAL_SCALAR_DENSE for op in reads)


def test_seeded_item_in_a_straight_line_entry_fires_host_sync():
    fn, args = ga.ENTRIES_BY_NAME["fused-apply-plain"].build()

    def doctored(*a):
        out = fn(*a)
        out.applied_count.item()  # a host read the entry does not declare
        return out

    findings = ga.audit_fn("doctored-apply", doctored, args)
    assert [f.rule for f in findings] == ["host-sync"], render_text(findings)
    assert "1 host read(s) recorded, 0 declared" in findings[0].message


def test_seeded_double_on_the_hash_path_fires_the_dtype_rule():
    from ringpop_tpu_torch.ops import farmhash as fh

    fn, args = ga.ENTRIES_BY_NAME["farmhash-plain"].build()

    def doctored(mat, lens):
        return fh.hash32_rows(mat, lens, impl="plain").double()

    findings = ga.audit_fn("doctored-hash", doctored, args)
    assert {f.rule for f in findings} == {"wide-dtype-on-hash-path"}, render_text(findings)
    assert "float64" in findings[0].message
    # the same widening of a value off the hash path is no finding
    assert ga.audit_fn("lens", lambda m, n: n.double(), args) == []


def test_allowlisted_widening_is_allowed_and_a_dead_row_is_a_finding(monkeypatch):
    from ringpop_tpu_torch.ops import farmhash as fh
    from ringpop_tpu_torch.ops import u32

    fn, args = ga.ENTRIES_BY_NAME["farmhash-plain"].build()

    def widened(mat, lens):
        return u32.to_u64(fh.hash32_rows(mat, lens, impl="plain"))

    assert [f.rule for f in ga.audit_fn("w", widened, args)] == ["wide-dtype-on-hash-path"]
    key = "ops/u32.py:to_u64"
    monkeypatch.setitem(ga.HASH_WIDENING_ALLOWLIST, key, "test")
    assert ga.audit_fn("w", widened, args) == []
    monkeypatch.setattr(ga, "_TRACE_CACHE", {})
    monkeypatch.setattr(ga, "_ALLOWLIST_HITS", set())
    monkeypatch.setattr(ga, "DEFAULT_ENTRIES", [ga.ENTRIES_BY_NAME["fused-apply-plain"]])
    findings = ga.audit_entries()
    assert {f.path for f in findings} == {"<entry:allowlist>"}
    assert any(key in f.message for f in findings)


def test_an_upload_of_a_host_table_is_a_host_sync():
    def upload(x):
        return x + torch.as_tensor([1, 2], dtype=torch.int32)  # a table: a copy on the card

    def scalar(x):
        y = x.clone()
        y[0] = 7  # a lifted Python scalar stays a CPU operand
        return y

    x = torch.zeros(2, dtype=torch.int32)
    assert [f.rule for f in ga.audit_fn("upload", upload, (x,))] == ["host-sync"]
    assert ga.audit_fn("scalar", scalar, (x,)) == []


def test_a_failing_entry_is_a_trace_failure():
    def broken(x):
        raise RuntimeError("boom")

    findings = ga.audit_fn("broken", broken, (torch.zeros(2, dtype=torch.int32),))
    assert [f.rule for f in findings] == ["trace-failure"]


def test_recorder_models_views_and_in_place_writes():
    a = torch.arange(6, dtype=torch.int32)
    b = torch.ones(6, dtype=torch.int32)

    def fn(a, b):
        v = a[2:]  # a view: a's value
        v.add_(b[2:])  # a new version of a's storage
        return a, b.clone()

    rec = dataflow.record(fn, (a, b))
    reach = dataflow.slice_reachability(rec, ["b", None])
    assert list(reach[0]) == ["b"]  # b reached a through the in-place add
    assert reach[1] == {}
    chain = dataflow.witness_chain(reach[0]["b"])
    assert "add_" in chain


def test_host_read_carries_control_dependence():
    def fn(x, y):
        if bool(x.sum(dtype=torch.int64) > 0):  # a host read of x
            return y + 1
        return y

    rec = dataflow.record(fn, (torch.ones(3, dtype=torch.int32),
                               torch.zeros(3, dtype=torch.int32)))
    reach = dataflow.slice_reachability(rec, ["x", None])
    assert "x" in reach[0]
    assert "<host-read" in dataflow.witness_chain(reach[0]["x"])
