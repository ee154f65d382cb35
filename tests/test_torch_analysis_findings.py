"""The port's finding model against the JAX package's: the same findings
render to the same text and json, and the same sources (marker word
swapped) parse to the same suppressions and host-marked lines."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from ringpop_tpu.analysis import findings as jfm
from ringpop_tpu_torch.analysis import findings as pfm
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)

JAX_FIXTURES = Path(__file__).parent / "analysis" / "fixtures"
PORT_FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"

ROWS = [
    dict(rule="host-coerce", path="ringpop_tpu_torch/x.py", line=3, message="int() read",
         source="y = int(x)"),
    dict(rule="host-sync", path="<entry:engine-tick>", line=0, message="2 reads, 0 declared",
         prong="graph"),
    dict(rule="stale-registry-row", path="<registry:exchange>", line=0, message="gone",
         prong="kernels"),
    dict(rule="host-coerce", path="ringpop_tpu_torch/a.py", line=9, message="wrapped",
         source="int(", end_line=11),
    dict(rule="obs-interference", path="<entry:route-tick-histograms>", line=0,
         message="RouteState.hist reaches RouteState.rng", prong="noninterference"),
]


@pytest.mark.parametrize("rows", [ROWS, ROWS[:1], []], ids=["five", "one", "none"])
def test_render_text_and_json_equal_jax(rows):
    port = [pfm.Finding(**r) for r in rows]
    ref = [jfm.Finding(**r) for r in rows]
    assert pfm.render_text(port) == jfm.render_text(ref)
    assert pfm.render_json(port) == jfm.render_json(ref)
    meta = {"prong_seconds": {"ast": 1.5}}
    assert pfm.render_json(port, meta=meta) == jfm.render_json(ref, meta=meta)
    doc = json.loads(pfm.render_json(port, meta=meta))
    assert doc["count"] == len(rows) and doc["prong_seconds"] == {"ast": 1.5}


def _jax_sources():
    return sorted(JAX_FIXTURES.glob("*.py"))


@pytest.mark.parametrize("path", _jax_sources(), ids=lambda p: p.name)
def test_parse_suppressions_equal_jax_with_the_marker_swapped(path):
    src = path.read_text()
    swapped = src.replace("jaxgate:", "torchgate:")
    assert pfm.parse_suppressions(swapped) == jfm.parse_suppressions(src)
    assert pfm.host_marked_lines(swapped) == jfm.host_marked_lines(src)
    # the other package's marker is no marker
    assert pfm.parse_suppressions(src) == {} or "torchgate" in src


def test_marker_grammar_on_the_port_fixture():
    src = (PORT_FIXTURES / "suppressed.py").read_text()
    table = pfm.parse_suppressions(src)
    assert table == jfm.parse_suppressions(src.replace("torchgate:", "jaxgate:"))
    assert None in table.values() and {"host-coerce"} in table.values()
    assert len(pfm.host_marked_lines(src)) == 1


def test_is_suppressed_spans_the_statement():
    f = pfm.Finding(rule="host-coerce", path="p", line=3, message="m", end_line=5)
    assert pfm.is_suppressed(f, {5: {"host-coerce"}})
    assert pfm.is_suppressed(f, {4: None})
    assert not pfm.is_suppressed(f, {5: {"implicit-dtype"}})
    assert not pfm.is_suppressed(f, {6: None})
    jf = jfm.Finding(rule="host-coerce", path="p", line=3, message="m", end_line=5)
    for table in ({5: {"host-coerce"}}, {4: None}, {5: {"implicit-dtype"}}, {6: None}):
        assert pfm.is_suppressed(f, table) == jfm.is_suppressed(jf, table)


def test_untokenizable_source_has_no_suppressions():
    src = 'x = """never closed  # torchgate: ignore\n'
    assert pfm.parse_suppressions(src) == {}
