"""The ``scale`` prong of the port's analysis: its manifest verdicts equal
JAX's on the same synthetic manifests; each port entry's footprint degree
equals the committed JAX ``SCALE_BUDGET.json``'s for its counterpart (or
the difference is named with its reason); the budget is the card's memory;
an [N, N, N] temp collapses N* and drifts the degree; ``--write`` refuses a
failed entry."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from ringpop_tpu.analysis import scale_budget as jsb
from ringpop_tpu_torch.analysis import dataflow, graph_audit as ga, manifests
from ringpop_tpu_torch.analysis import scale_budget as sb
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]

# JAX entries whose port counterpart's degree differs, and why
DEGREE_DIFFERENCES = {
    "fused-checksum-pallas": (
        "the kernel entry records its plain version on the CPU (an O(N) stream a row); "
        "JAX's Pallas lowering kept an [N, N]-word block buffer in its jaxpr"
    ),
}


def _rules(findings):
    return sorted((f.rule, f.path) for f in findings)


MANIFEST = {"entries": {
    "same": {"degree": 1, "n_star": 1000},
    "deg": {"degree": 1, "n_star": 1000},
    "shrunk": {"degree": 2, "n_star": 1000},
    "grown": {"degree": 2, "n_star": 1000},
    "within": {"degree": 2, "n_star": 1000},
    "gone": {"degree": 1, "n_star": 5},
    "broken": {"degree": 1, "n_star": 5},
}}
ACTUAL = {
    "same": {"degree": 1, "n_star": 1000},
    "deg": {"degree": 2, "n_star": 1000},
    "shrunk": {"degree": 2, "n_star": 900},
    "grown": {"degree": 2, "n_star": 1100},
    "within": {"degree": 2, "n_star": 1040},
    "broken": {"error": "boom"},
    "new": {"degree": 1, "n_star": 7},
    "new-broken": {"error": "boom"},
}


def test_manifest_verdicts_equal_jax(tmp_path):
    assert sb.DEFAULT_RTOL == jsb.DEFAULT_RTOL
    got = _rules(sb.compare_to_manifest(ACTUAL, MANIFEST))
    assert got == _rules(jsb.compare_to_manifest(ACTUAL, MANIFEST))
    assert ("scale-budget", "<entry:gone>") in got and ("scale-failure", "<entry:broken>") in got
    missing = tmp_path / "none.json"
    assert _rules(sb.check_against_manifest(path=missing)) == \
        _rules(jsb.check_against_manifest(entry_names=[], path=missing))


def test_degrees_equal_jax_counterparts():
    jax_doc = json.loads((REPO / "SCALE_BUDGET.json").read_text())["entries"]
    port = manifests.load(sb.MANIFEST_NAME)["entries"]
    for jname, pname in ga.JAX_ENTRY_COUNTERPARTS.items():
        if jname not in jax_doc:
            continue
        same = port[pname]["degree"] == jax_doc[jname]["degree"]
        assert same != (jname in DEGREE_DIFFERENCES), (jname, port[pname], jax_doc[jname])


def test_budget_is_the_cards_memory():
    doc = manifests.load(sb.MANIFEST_NAME)
    assert doc["hbm_budget_bytes"] == sb.HBM_BUDGET_BYTES == sb.CARD_TOTAL_MEMORY
    assert sb.HBM_BUDGET_BYTES > jsb.HBM_BUDGET_BYTES  # the H100's 80 GB, not a TPU's 12 GiB
    assert set(doc["entries"]) == set(ga.ENTRIES_BY_NAME)


def test_an_n_cubed_temp_collapses_n_star_and_drifts_the_degree():
    fn, args = ga._entry_fused_piggyback("plain")

    def doctored(*a):
        out = fn(*a)
        cube = torch.zeros(a[1].shape[0], a[1].shape[0], a[1].shape[0], dtype=torch.int32)
        return out, cube + 1

    rec = dataflow.record(doctored, args, detail=True)
    name = "fused-piggyback-plain"
    actual = {name: sb.entry_budget(name, rec)}
    assert actual[name]["degree"] == 3
    committed = manifests.load(sb.MANIFEST_NAME)
    found = sb.compare_to_manifest(actual, dict(committed, entries={
        name: committed["entries"][name]}))
    text = " ".join(f.message for f in found)
    assert {f.rule for f in found} == {"scale-budget"}
    assert "degree changed" in text and "shrank" in text


def test_write_refuses_a_failed_entry(tmp_path):
    with pytest.raises(ValueError, match="failed entries"):
        sb.write_manifest({"x": {"error": "boom"}}, tmp_path / "s.json")
    p = sb.write_manifest({"x": {"degree": 1, "n_star": 3}}, tmp_path / "s.json")
    assert json.loads(p.read_text())["entries"] == {"x": {"degree": 1, "n_star": 3}}
