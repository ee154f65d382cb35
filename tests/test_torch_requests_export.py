"""The host half of the port's request observatory against the JAX
package's, on the same decoded records: ``reconcile_records``,
``reconcile_metrics``, ``outcome_label``, ``request_span``, ``span_trees``
and ``export_request_trace``.  Two record sets: the requests of the
committed ``runlogs/sample_requests_n64`` sidecar, and a seeded synthetic
buffer in which every outcome bit and every reroute code occurs.
Tolerance: none (plain Python and numpy on both sides)."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest

from ringpop_tpu.obs import requests as joreq
from ringpop_tpu_torch.models.route import plane as pplane
from ringpop_tpu_torch.obs import chrome_trace as pct
from ringpop_tpu_torch.obs import requests as poreq

REPO_ROOT = Path(__file__).resolve().parents[1]
SAMPLE = REPO_ROOT / "runlogs" / "sample_requests_n64.requests.trace.json"


def _public_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(el, ast.Name):
                        names.add(el.id)
    return {n for n in names if not n.startswith("_")}


def _sample_records():
    events = json.loads(SAMPLE.read_text())["traceEvents"]
    return [dict(e["args"]) for e in events if e["ph"] == "X"]


def _synthetic_buffer(cap=512, head=400, n=32, seed=11):
    rng = np.random.default_rng(seed)
    buf = np.zeros((cap, poreq.RECORD_WIDTH), np.int32)
    buf[:, poreq.F_TICK] = np.sort(rng.integers(0, 40, cap))
    buf[:, poreq.F_KEY] = rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.uint32).view(
        np.int32)
    buf[:, poreq.F_SENDER] = rng.integers(0, n, cap)
    buf[:, poreq.F_DEST] = rng.integers(0, n, cap)
    buf[:, poreq.F_OWNER_TRUTH] = rng.integers(-1, n, cap)
    buf[:, poreq.F_MISROUTE] = rng.integers(0, 2, cap)
    buf[:, poreq.F_REROUTE] = rng.integers(0, 3, cap)
    buf[:, poreq.F_RETRY_DEPTH] = rng.integers(0, 3, cap)
    buf[:, poreq.F_MULTI] = rng.integers(0, 2, cap)
    buf[:, poreq.F_OUTCOME] = rng.integers(0, 8, cap)
    # a few keys repeat, so a key's span tree holds several requests
    buf[::7, poreq.F_KEY] = buf[0, poreq.F_KEY]
    return buf, head


def _derived_counts(buf, head):
    arrs = poreq.decode_arrays(buf, head)
    return np.asarray([poreq._RECORD_DERIVE[f](arrs) for f in poreq.COUNT_FIELDS], np.int32)


def test_every_public_name_of_the_jax_module_is_ported():
    jax_names = _public_names(REPO_ROOT / "ringpop_tpu" / "obs" / "requests.py")
    port_names = _public_names(REPO_ROOT / "ringpop_tpu_torch" / "obs" / "requests.py")
    assert jax_names - port_names == set()


def test_registries_equal_jax():
    assert poreq.METRIC_FIELDS == joreq.METRIC_FIELDS
    assert poreq.REQ_PID == joreq.REQ_PID
    assert set(poreq._RECORD_DERIVE) == set(joreq._RECORD_DERIVE) == set(poreq.COUNT_FIELDS)
    # every sampled counter names a RouteMetrics field of the port
    assert set(poreq.METRIC_FIELDS.values()) <= set(pplane.RouteMetrics._fields)


def test_synthetic_buffer_covers_every_code():
    buf, head = _synthetic_buffer()
    rows = buf[:head]
    assert set(rows[:, poreq.F_REROUTE]) == {poreq.RR_NONE, poreq.RR_LOCAL, poreq.RR_REMOTE}
    for bit in (poreq.OUT_CHECKSUMS_DIFFER, poreq.OUT_CHECKSUM_REJECT, poreq.OUT_KEYS_DIVERGED):
        assert (rows[:, poreq.F_OUTCOME] & bit).any()
    labels = {poreq.outcome_label(r) for r in poreq.decode_requests(buf, head)}
    assert labels == {"abort.keys-diverged", "reject.checksum", "reroute.remote",
                      "reroute.local", "misroute", "ok"}


@pytest.mark.parametrize("doctor", [None, "queries", "reroute_remote", "checksum_rejects"])
def test_reconcile_records_equals_jax(doctor):
    buf, head = _synthetic_buffer()
    counts = _derived_counts(buf, head)
    if doctor is not None:
        counts[poreq.COUNT_FIELDS.index(doctor)] += 1
    got = poreq.reconcile_records(buf, head, counts)
    assert got == joreq.reconcile_records(buf, head, counts)
    assert all(v["match"] for v in got.values()) is (doctor is None)


@pytest.mark.parametrize("as_tuple", [False, True])
def test_reconcile_metrics_equals_jax(as_tuple):
    buf, head = _synthetic_buffer()
    counts = _derived_counts(buf, head)
    rng = np.random.default_rng(5)
    metrics = {f: rng.integers(0, 60, 8).astype(np.int32) for f in pplane.RouteMetrics._fields}
    # one counter below its sampled restriction: not ok on both sides
    metrics["route_misroutes"][:] = 0
    if as_tuple:
        metrics = pplane.RouteMetrics(**metrics)
    got = poreq.reconcile_metrics(counts, metrics)
    assert got == joreq.reconcile_metrics(counts, metrics)
    assert not got["misroutes"]["ok"] and set(got) == set(poreq.COUNT_FIELDS)


@pytest.mark.parametrize("source", ["sample", "synthetic"])
def test_spans_and_export_equal_jax(source):
    if source == "sample":
        reqs, n = _sample_records(), 64
    else:
        buf, head = _synthetic_buffer()
        reqs, n = poreq.decode_requests(buf, head), 32
    assert reqs
    assert [poreq.outcome_label(r) for r in reqs] == [joreq.outcome_label(r) for r in reqs]
    assert [poreq.request_span(r) for r in reqs] == [joreq.request_span(r) for r in reqs]
    trees = poreq.span_trees(reqs)
    assert trees == joreq.span_trees(reqs)
    assert sum(len(v) for v in trees.values()) == len(reqs)
    for period_ms in (200, 50):
        trace = poreq.export_request_trace(reqs, n, period_ms=period_ms)
        assert trace == joreq.export_request_trace(reqs, n, period_ms=period_ms)
        assert pct.validate_chrome_trace(trace) == []
    if source == "sample":  # the committed sidecar is this export of its own records
        assert poreq.export_request_trace(reqs, n)["traceEvents"] == json.loads(
            SAMPLE.read_text())["traceEvents"]


def test_span_trees_refuses_raw_rows():
    buf, head = _synthetic_buffer()
    for fn in (poreq.span_trees, joreq.span_trees):
        with pytest.raises(TypeError):
            fn(buf[:head].tolist())
