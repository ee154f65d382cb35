"""The ``retrace`` prong of the port's analysis: its manifest verdicts
equal JAX's on the same synthetic manifests; a per-call upload of a host
table is a retrace drift; a probe that breaks is ``probe-failure``; the
probes stand for JAX's; ``--write`` refuses a failed probe."""

from __future__ import annotations

import json

import pytest
import torch

from ringpop_tpu.analysis import retrace as jret
from ringpop_tpu_torch.analysis import manifests, retrace
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _rules(findings):
    return sorted((f.rule, f.path) for f in findings)


def _steps(jax_side: bool, counts):
    if jax_side:
        return [{"desc": "s%d" % i, "cache_size": c} for i, c in enumerate(counts)]
    return [{"desc": "s%d" % i, "uploads": c, "device_tables": 1, "library_builds": 0,
             "custom_ops": 6} for i, c in enumerate(counts)]


def _case(jax_side: bool):
    s = lambda *c: _steps(jax_side, c)  # noqa: E731
    manifest = {"probes": {"same": s(1, 1, 2), "more": s(1, 1, 2), "fewer": s(1, 1, 2),
                           "shorter": s(1, 1, 2), "gone": s(1), "broken": s(1)}}
    actual = {"same": s(1, 1, 2), "more": s(1, 2, 2), "fewer": s(1, 1, 1), "shorter": s(1, 1),
              "broken": [{"error": "boom"}], "new": s(1), "new-broken": [{"error": "boom"}]}
    return actual, manifest


def test_manifest_verdicts_equal_jax(tmp_path):
    got = _rules(retrace.compare_to_manifest(*_case(False)))
    assert got == _rules(jret.compare_to_manifest(*_case(True)))
    assert ("probe-failure", "<probe:broken>") in got
    # a missing manifest: the same rule (the port's file is RETRACE_BUDGET.json,
    # JAX's ANALYSIS_BUDGET.json)
    missing = tmp_path / "none.json"
    got = retrace.check_against_manifest(probes=[], path=missing)
    want = jret.check_against_manifest(probes=[], path=missing)
    assert [(f.rule, f.path) for f in got] == [("retrace-budget", retrace.MANIFEST_NAME)]
    assert [f.rule for f in want] == ["retrace-budget"]


def _probe(upload_each_call: bool):
    def build(device):
        def fn(x):
            if upload_each_call:
                return x + torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=device)
            return x + 1

        return fn, [("values A", (torch.zeros(4, dtype=torch.int32),)),
                    ("values B", (torch.ones(4, dtype=torch.int32),)),
                    ("[8]", (torch.ones(8, dtype=torch.int32)[:4],))]

    return retrace.Probe("doctored", build)


def test_a_per_call_table_upload_is_a_retrace_drift():
    clean = retrace.run_probes([_probe(False)])
    doctored = retrace.run_probes([_probe(True)])
    assert [s["uploads"] for s in clean["doctored"]] == [0, 0, 0]
    assert [s["uploads"] for s in doctored["doctored"]] == [1, 1, 1]
    found = retrace.compare_to_manifest(doctored, {"probes": clean})
    assert [f.rule for f in found] == ["retrace-budget"] * 3
    assert all("silent reload or upload" in f.message for f in found)


def test_a_broken_probe_is_a_probe_failure(tmp_path):
    bad = retrace.Probe("bad", lambda device: (lambda: 1 / 0, [("s", ())]))
    out = retrace.run_probes([bad])
    assert "ZeroDivisionError" in out["bad"][0]["error"]
    assert [f.rule for f in retrace.compare_to_manifest(out, {"probes": {}})] == ["probe-failure"]
    with pytest.raises(ValueError, match="failed entries"):
        retrace.write_manifest(out, tmp_path / "r.json")


def test_probes_stand_for_jaxs():
    jax_doc = json.loads((manifests.BUDGET_DIR.parents[2] / "ANALYSIS_BUDGET.json").read_text())
    assert set(retrace.JAX_COUNTERPARTS) == set(jax_doc["probes"])
    names = [p.name for p in retrace.DEFAULT_PROBES]
    assert sorted(retrace.JAX_COUNTERPARTS.values()) == sorted(names)
    doc = manifests.load(retrace.MANIFEST_NAME)["probes"]
    assert set(doc) == set(names)
    for name, steps in doc.items():
        assert len(steps) == 3 and all(s["library_builds"] == 0 for s in steps), name
        assert steps[1]["uploads"] == steps[2]["uploads"] == 0, name
