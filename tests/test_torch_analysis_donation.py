"""The ``donation`` prong of the port's analysis (the aliasing surface):
its manifest verdicts equal JAX's on the same synthetic manifests; an
entry writing its input in place is ``inplace-input-write``; the
wavefront tick's ``first_heard`` column write lands in the tick's own copy;
JAX's five donating entries have counterparts; ``--write`` refuses failed
entries and undeclared writes; the kernels' pointer tables split into
operands and results for the card's aliasing audit."""

from __future__ import annotations

import json

import pytest

from ringpop_tpu.analysis import donation as jdon
from ringpop_tpu_torch.analysis import dataflow, donation, manifests
from ringpop_tpu_torch.ops import _build
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _rules(findings):
    return sorted((f.rule, f.path) for f in findings)


def _surfaces(jax_side: bool):
    """One surface per case, in JAX's keys or the port's."""
    if jax_side:
        same = {"donated_params": 3, "aliased_params": 3, "aliases": ["out{0} <- param 0"],
                "dropped": []}
        other = dict(same, aliases=[])
    else:
        same = {"input_leaves": 3, "output_leaves": 3, "written_inputs": [],
                "aliased_outputs": ["A.x <- A.x"]}
        other = dict(same, aliased_outputs=[])
    manifest = {"entries": {"same": same, "changed": same, "gone": same, "broken": same}}
    actual = {"same": same, "changed": other, "broken": {"error": "boom"}, "new": same,
              "new-broken": {"error": "boom"}}
    return actual, manifest


def test_manifest_verdicts_equal_jax(tmp_path):
    got = _rules(donation.compare_to_manifest(*_surfaces(False)))
    assert got == _rules(jdon.compare_to_manifest(*_surfaces(True)))
    assert ("donation-failure", "<entry:broken>") in got
    missing = tmp_path / "none.json"
    assert _rules(donation.check_against_manifest(path=missing)) == \
        _rules(jdon.check_against_manifest(path=missing))


def test_jax_donating_entries_have_counterparts():
    jax_doc = json.loads((donation.manifests.BUDGET_DIR.parents[2] /
                          "DONATION_BUDGET.json").read_text())
    assert set(donation.JAX_COUNTERPARTS) == set(jax_doc["entries"])
    names = {e.name for e in donation.DEFAULT_ENTRIES}
    assert set(donation.JAX_COUNTERPARTS.values()) <= names
    assert set(manifests.load(donation.MANIFEST_NAME)["entries"]) == names


def _writer():
    fn, args = donation._entry_scalable_tick()

    def doctored(state, inputs):
        state.partition.add_(1)  # the caller's state, written in place
        return fn(state, inputs)

    return doctored, args


def test_an_entry_writing_its_input_in_place_is_found():
    entry = donation.DonationEntry("doctored", _writer)
    actual = donation.collect(entries=[entry])
    assert actual["doctored"]["written_inputs"] == ["ScalableState.partition"]
    found = donation.compare_to_manifest(actual, {"entries": {"doctored": actual["doctored"]}})
    assert [f.rule for f in found] == ["inplace-input-write"]
    with pytest.raises(ValueError, match="undeclared in-place"):
        donation.write_manifest(actual, path=None)


def test_the_wavefront_column_write_lands_in_the_ticks_own_copy():
    fn, args = donation._entry_scalable_tick(wavefront=True)
    fn(*args)
    fn, args = donation._entry_scalable_tick(wavefront=True)
    rec = dataflow.record(fn, args, detail=True)
    writes = [op for op in rec.ops if op.name == "aten::index_copy_"]
    assert writes and all(op.loc.endswith("_publish_batch") for op in writes)
    surface = donation.surface(rec, args)
    assert surface["written_inputs"] == []
    assert not any(a.startswith("ScalableState.first_heard") for a in surface["aliased_outputs"])


def test_write_refuses_a_failed_entry(tmp_path):
    with pytest.raises(ValueError, match="failed entries"):
        donation.write_manifest({"x": {"error": "boom"}}, tmp_path / "d.json")


def test_kernel_read_pointers_cover_every_entry():
    """chip_smoke.py's aliasing audit splits each launch's pointer table into
    operands and results by ``_build.READ_POINTERS``."""
    assert set(_build.READ_POINTERS) == set(_build.ENTRY_POINTS)
    for name, (n_ptrs, _) in _build.ENTRY_POINTS.items():
        assert 0 < _build.READ_POINTERS[name] < n_ptrs, name
