"""The ``ast`` prong of the port's analysis: a bad/good fixture pair per
rule (each bad fixture fires its own rule and no other), suppressions and
the host marker, scoping, tick-context inference, and the clean tree."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from ringpop_tpu_torch.analysis import astlint
from ringpop_tpu_torch.analysis.findings import render_text

FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
PKG_ROOT = Path(astlint.__file__).resolve().parents[1]

# rule -> (fixture stem, the path the fixture is linted as, bad findings)
CASES = {
    "host-coerce": ("host_coerce", "ringpop_tpu_torch/models/sim/fx.py", 5),
    "np-on-traced": ("np_on_traced", "ringpop_tpu_torch/models/sim/fx.py", 2),
    "implicit-dtype": ("implicit_dtype", "ringpop_tpu_torch/ops/fx.py", 5),
    "implicit-accum-dtype": ("implicit_accum_dtype", "ringpop_tpu_torch/ops/fx.py", 3),
    "py-random-time": ("py_random_time", "ringpop_tpu_torch/models/sim/fx.py", 4),
    "mutable-default": ("mutable_default", "ringpop_tpu_torch/obs/fx.py", 4),
    "block-until-ready": ("block_until_ready", "ringpop_tpu_torch/ops/fx.py", 1),
    "assert-on-traced": ("assert_on_traced", "ringpop_tpu_torch/models/sim/fx.py", 1),
    "inplace-on-state": ("inplace_on_state", "ringpop_tpu_torch/models/sim/fx.py", 3),
}


def _lint(stem: str, rel: str, **kw):
    return astlint.lint_source((FIXTURES / f"{stem}.py").read_text(), rel, **kw)


def test_every_rule_has_a_fixture_pair():
    assert set(CASES) == set(astlint.RULES_BY_NAME)
    for stem, _, _ in CASES.values():
        assert (FIXTURES / f"{stem}_bad.py").is_file()
        assert (FIXTURES / f"{stem}_good.py").is_file()


@pytest.mark.parametrize("rule", sorted(CASES))
def test_bad_fixture_fires_only_its_rule(rule):
    stem, rel, count = CASES[rule]
    hits = _lint(f"{stem}_bad", rel)
    assert {f.rule for f in hits} == {rule}, render_text(hits)
    assert len(hits) == count, render_text(hits)
    assert all(f.line > 0 and f.path == rel and f.prong == "ast" for f in hits)
    # each finding sits on a line the fixture marks
    lines = (FIXTURES / f"{stem}_bad.py").read_text().splitlines()
    for f in hits:
        span = lines[f.line - 1:max(f.line, f.end_line)]
        assert any("finding: " + rule in line for line in span), (f.line, f.source)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_good_fixture_is_clean(rule):
    stem, rel, _ = CASES[rule]
    hits = _lint(f"{stem}_good", rel)
    assert hits == [], render_text(hits)


def test_scoped_rules_stay_out_of_host_paths():
    # the device-path rules read nothing outside ops/, models/, parallel/, fuzz/
    for rule, stem in (("implicit-dtype", "implicit_dtype"),
                       ("implicit-accum-dtype", "implicit_accum_dtype"),
                       ("block-until-ready", "block_until_ready"),
                       ("inplace-on-state", "inplace_on_state")):
        hits = _lint(f"{stem}_bad", "ringpop_tpu_torch/obs/fx.py")
        assert [f for f in hits if f.rule == rule] == [], rule


def test_suppressions_and_host_marker():
    rel = "ringpop_tpu_torch/models/sim/fx.py"
    hits = _lint("suppressed", rel)
    # named and bare suppressions silence their lines; the mis-named
    # ignore[implicit-dtype] does not silence the float() host read
    assert [f.rule for f in hits] == ["host-coerce"]
    assert "float" in hits[0].source
    raw = _lint("suppressed", rel, respect_suppressions=False)
    # all four reads fire unsuppressed, the wrapped one too; the host-marked
    # helper stays exempt either way
    assert len([f for f in raw if f.rule == "host-coerce"]) == 4


def test_marker_inside_a_string_is_not_a_suppression():
    src = '''
import torch

def step(x):
    msg = "suppress with  # torchgate: ignore  on the line"; y = int(x)
    return y

def run(xs):
    return torch.func.vmap(step)(xs)
'''
    rel = "ringpop_tpu_torch/models/sim/fx.py"
    assert any(f.rule == "host-coerce" for f in astlint.lint_source(src, rel))
    ok = src.replace('"suppress with  # torchgate: ignore  on the line"; y = int(x)',
                     '"doc"; y = int(x)  # torchgate: ignore[host-coerce]')
    assert not any(f.rule == "host-coerce" for f in astlint.lint_source(ok, rel))


def test_nested_def_reported_once_and_closure_taint_carried():
    src = '''
import torch

def outer(x):
    def inner(y):
        return int(y)
    def captured():
        return int(x)
    return inner(x) + captured()

def run(xs):
    return torch.func.vmap(outer)(xs)
'''
    hits = astlint.lint_source(src, "ringpop_tpu_torch/models/sim/fx.py")
    assert sorted(f.line for f in hits if f.rule == "host-coerce") == [6, 8]


def test_context_inference_follows_calls_and_registered_roots():
    src = '''
import torch

def helper(x):
    return int(x)

def tick(state, inputs):
    return helper(state)
'''
    # `tick` of models/sim/engine.py is a registered root; `helper` joins
    # its context through the call
    hits = astlint.lint_source(src, "ringpop_tpu_torch/models/sim/engine.py")
    assert [f.line for f in hits if f.rule == "host-coerce"] == [5]
    assert astlint.lint_source(src, "ringpop_tpu_torch/models/sim/other.py") == []


def test_collective_answers_are_exempt():
    src = '''
def run_solo(body):
    op, x = body.send(None)
    return bool(x)

def tick(state, inputs):
    return run_solo(state)
'''
    rel = "ringpop_tpu_torch/models/sim/engine_scalable.py"
    assert [f for f in astlint.lint_source(src, rel) if f.rule == "host-coerce"] == []
    hits = astlint.lint_source(src, "ringpop_tpu_torch/models/sim/engine.py")
    assert [f.rule for f in hits] == ["host-coerce"]


def test_traced_entries_resolve():
    # every registered root exists in its module: a typo would silently
    # drop a tick context and its rules
    for suffix, names in astlint.TRACED_ENTRIES.items():
        path = PKG_ROOT / suffix
        assert path.is_file(), suffix
        tree = ast.parse(path.read_text())
        defined = {n.name for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        assert not names - defined, (suffix, sorted(names - defined))


def test_syntax_error_and_unreadable_file_are_findings(tmp_path):
    bad = tmp_path / "ringpop_tpu_torch" / "ops"
    bad.mkdir(parents=True)
    (bad / "broken.py").write_text("def f(:\n")
    hits = astlint.lint_paths(tmp_path / "ringpop_tpu_torch")
    assert [f.rule for f in hits] == ["syntax-error"]
    missing = astlint.lint_paths(tmp_path / "ringpop_tpu_torch", files=[bad / "missing.py"])
    assert [f.rule for f in missing] == ["unreadable-file"]


def test_ast_prong_tree_is_clean():
    hits = astlint.lint_paths(PKG_ROOT)
    assert hits == [], "\n" + render_text(hits)
