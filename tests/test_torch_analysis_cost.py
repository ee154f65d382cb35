"""The ``cost`` prong of the port's analysis: its manifest verdicts equal
JAX's on the same synthetic manifests; a plane widened to int64 is a cost
drift; the manifest records its backend and torch version; a kernel
wrapper's entry records its plain version on the CPU; ``--write`` refuses a
failed entry."""

from __future__ import annotations

import json

import pytest
import torch

from ringpop_tpu.analysis import cost as jcost
from ringpop_tpu_torch.analysis import cost, dataflow, manifests
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _rules(findings):
    return sorted((f.rule, f.path) for f in findings)


MANIFEST = {"entries": {
    "same": {"ops": 10, "peak_bytes": 100},
    "up": {"ops": 10, "peak_bytes": 100},
    "down": {"ops": 10, "peak_bytes": 100},
    "within": {"ops": 10, "peak_bytes": 100},
    "one-side": {"ops": 10, "peak_bytes": 100},
    "gone": {"ops": 1},
    "broken": {"ops": 1},
}}
ACTUAL = {
    "same": {"ops": 10, "peak_bytes": 100},
    "up": {"ops": 10, "peak_bytes": 200},
    "down": {"ops": 5, "peak_bytes": 100},
    "within": {"ops": 10, "peak_bytes": 105},
    "one-side": {"ops": 10},
    "broken": {"error": "boom"},
    "new": {"ops": 3},
    "new-broken": {"error": "boom"},
}


def test_manifest_verdicts_equal_jax(tmp_path):
    assert cost.DEFAULT_RTOL == jcost.DEFAULT_RTOL
    got = _rules(cost.compare_to_manifest(ACTUAL, MANIFEST))
    assert got == _rules(jcost.compare_to_manifest(ACTUAL, MANIFEST))
    assert got.count(("cost-budget", "<entry:up>")) == 1
    missing = tmp_path / "none.json"
    assert _rules(cost.check_against_manifest(path=missing)) == \
        _rules(jcost.check_against_manifest(entry_names=[], path=missing))


def _costs(dtype):
    x = torch.arange(64, dtype=dtype).reshape(8, 8)
    return cost.costs_of(dataflow.record(lambda t: (t * 2 + 1).sum(dim=1), (x,), detail=True))


def test_a_plane_widened_to_int64_is_a_cost_drift():
    base, wide = _costs(torch.int32), _costs(torch.int64)
    assert base["ops"] == wide["ops"] == 3
    assert wide["bytes_accessed"] > 1.8 * base["bytes_accessed"]
    found = cost.compare_to_manifest({"e": wide}, {"entries": {"e": base}})
    keys = {f.message.split(":")[0] for f in found}
    assert {f.rule for f in found} == {"cost-budget"}
    assert {"bytes_accessed", "argument_size_in_bytes", "peak_bytes"} <= keys
    # [8, 8] int32 in; the row sums come out int64 (torch accumulates ints in int64)
    assert base["argument_size_in_bytes"] == 256 and base["output_size_in_bytes"] == 64


def test_manifest_records_backend_and_torch_version(tmp_path):
    doc = manifests.load(cost.MANIFEST_NAME)
    assert doc["backend"] == "cpu" and doc["torch_version"].startswith("2.")
    # a subset diffs its slice of the manifest only
    p = tmp_path / "c.json"
    p.write_text(json.dumps(dict(doc, entries=dict(doc["entries"], extra={"ops": 1}))))
    assert cost.check_against_manifest(["fused-piggyback-plain"], path=p) == []


def test_kernel_entries_record_their_plain_versions():
    entries = manifests.load(cost.MANIFEST_NAME)["entries"]
    for kernel in ("fused-apply", "fused-piggyback", "fused-stream", "block-loop", "exchange",
                   "farmhash", "fused-checksum"):
        assert entries[kernel + "-kernel"] == entries[kernel + "-plain"], kernel


def test_write_refuses_a_failed_entry(tmp_path):
    with pytest.raises(ValueError, match="failed entries"):
        cost.write_manifest({"x": {"error": "boom"}}, tmp_path / "c.json")
