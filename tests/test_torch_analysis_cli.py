"""The port's analysis CLI and prong registry: the registry, the CLI's
dispatch, ``--list-rules`` and the README's port prong table agree; json
output carries each prong's wall time; and every registered rule has a
mutation that makes the CLI exit non-zero and name it."""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

from ringpop_tpu_torch.analysis import __main__ as cli
from ringpop_tpu_torch.analysis import astlint
from ringpop_tpu_torch.analysis import graph_audit as ga
from ringpop_tpu_torch.analysis import noninterference as ni
from ringpop_tpu_torch.analysis.prongs import ALL_PRONGS, DEFAULT_PRONGS, PRONGS
from ringpop_tpu_torch.ops import toolkit

REPO_ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
TABLE_ROW = re.compile(r"^\| port \| `([a-z]+)` \| (yes|opt-in) \| (.+) \|$", re.M)


def test_registry_shape():
    assert ALL_PRONGS == ("ast", "graph", "kernels", "noninterference")
    assert DEFAULT_PRONGS == ALL_PRONGS
    for spec in PRONGS.values():
        assert spec.rules and spec.summary and spec.ci
        for test in spec.ci.split(" + "):
            assert (REPO_ROOT / test).is_file(), test


def test_cli_dispatch_covers_every_registered_prong():
    src = (REPO_ROOT / "ringpop_tpu_torch" / "analysis" / "__main__.py").read_text()
    for name in ALL_PRONGS:
        assert f'"{name}" in prongs' in src, name


def test_list_rules_prints_every_prong_and_rule(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for spec in PRONGS.values():
        assert f"{spec.name} prong" in out
        for rule in spec.rules:
            assert rule in out
    for rule in astlint.RULES_BY_NAME:
        assert rule in out


def test_readme_prong_table_matches_registry():
    readme = (REPO_ROOT / "README.md").read_text()
    rows = {m.group(1): (m.group(2), m.group(3).strip()) for m in TABLE_ROW.finditer(readme)}
    assert set(rows) == set(ALL_PRONGS)
    for name, spec in PRONGS.items():
        assert rows[name] == ("yes" if spec.default else "opt-in", spec.summary), name


def test_every_prong_name_is_accepted_on_an_empty_diff(monkeypatch, capsys):
    monkeypatch.setattr(cli, "_changed_files", lambda: [])
    for name in ALL_PRONGS:
        assert cli.main(["--prong", name, "--changed-only"]) == 0, name
        assert "0 finding(s)" in capsys.readouterr().out


def test_json_output_records_per_prong_wall_time(capsys):
    rc = cli.main(["--prong", "ast,kernels", "--format", "json",
                   "ringpop_tpu_torch/analysis/findings.py"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["count"] == 0
    assert set(doc["prong_seconds"]) == {"ast", "kernels"}
    assert all(v >= 0 for v in doc["prong_seconds"].values())


def test_cli_rejects_an_unknown_prong():
    with pytest.raises(SystemExit):
        cli.main(["--prong", "nope"])


# -- a mutation per registered rule, through the CLI --------------------------

AST_CASES = {
    "host-coerce": ("host_coerce_bad", "models/sim"),
    "np-on-traced": ("np_on_traced_bad", "models/sim"),
    "implicit-dtype": ("implicit_dtype_bad", "ops"),
    "implicit-accum-dtype": ("implicit_accum_dtype_bad", "ops"),
    "py-random-time": ("py_random_time_bad", "models/sim"),
    "mutable-default": ("mutable_default_bad", "obs"),
    "block-until-ready": ("block_until_ready_bad", "ops"),
    "assert-on-traced": ("assert_on_traced_bad", "models/sim"),
    "inplace-on-state": ("inplace_on_state_bad", "models/sim"),
}


def _ast_mutation(rule, tmp_path, monkeypatch):
    d = tmp_path / "ringpop_tpu_torch" / "ops"
    d.mkdir(parents=True)
    if rule == "syntax-error":
        (d / "fx.py").write_text("def f(:\n")
        return [str(d / "fx.py"), "--prong", "ast"]
    if rule == "unreadable-file":
        return [str(d / "missing.py"), "--prong", "ast"]
    stem, scope = AST_CASES[rule]
    target = tmp_path / "ringpop_tpu_torch" / scope / "fx.py"
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text((FIXTURES / f"{stem}.py").read_text())
    return [str(target), "--prong", "ast"]


def _graph_entry(monkeypatch, name, build, reads=0):
    ep = ga.EntryPoint(name, build, reads)
    monkeypatch.setattr(ga, "DEFAULT_ENTRIES", [ep])
    monkeypatch.setattr(ga, "ENTRIES_BY_NAME", {name: ep})
    monkeypatch.setattr(ga, "_TRACE_CACHE", {})
    monkeypatch.setattr(ga, "HASH_WIDENING_ALLOWLIST", {})


def _graph_mutation(rule, tmp_path, monkeypatch):
    from ringpop_tpu_torch.ops import farmhash as fh

    if rule == "host-sync":
        def build():
            fn, args = ga._entry_fused_apply("plain")
            return (lambda *a: (fn(*a), fn(*a).applied_count.item())), args
    elif rule == "wide-dtype-on-hash-path":
        def build():
            return (lambda m, n: fh.hash32_rows(m, n, impl="plain").double()), \
                ga._farmhash_args()
    else:
        def build():
            return (lambda x: x.item() + None), (torch.zeros(1, dtype=torch.int32),)
    _graph_entry(monkeypatch, "doctored", build)
    return ["--prong", "graph"]


def _kernel_mutation(rule, tmp_path, monkeypatch):
    rows = list(toolkit.TWIN_REGISTRY)
    ex = next(i for i, r in enumerate(rows) if r.kernel_entry == "exchange")
    change = {
        "unregistered-kernel": None,
        "missing-kernel-entry": dict(kernel_entry="no_such_entry"),
        "missing-twin-entry": dict(plain_entry="no_such_plain"),
        "missing-gate-test": dict(gate_test="tests/no_such_test.py"),
        "stale-registry-row": dict(source="ringpop_tpu_torch/csrc/no_such.cu"),
    }[rule]
    if change is None:
        del rows[ex]
    else:
        rows[ex] = dataclasses.replace(rows[ex], **change)
    monkeypatch.setattr(toolkit, "TWIN_REGISTRY", tuple(rows))
    return ["--prong", "kernels"]


def _ni_mutation(rule, tmp_path, monkeypatch):
    name = "engine-scalable-tick-exchange-metrics"
    real = ga.ENTRIES_BY_NAME[name]
    if rule == "obs-interference":
        def build():
            fn, args = real.build()

            def doctored(state, inputs):
                st, m = fn(state, inputs)
                return st._replace(tick_index=st.tick_index + st.exch[0, 0]), m
            return doctored, args
        ep = ga.EntryPoint(name, build, real.reads)
    elif rule == "unclassified-state-field":
        regs = dict(ni.state_registries())
        traj, obs = regs["ScalableState"]
        regs["ScalableState"] = (traj - {"heard"}, obs)
        monkeypatch.setattr(ni, "state_registries", lambda: regs)
        ep = real
    else:
        def build():
            fn, args = real.build()
            return (lambda s, i: s.no_such_field), args
        ep = ga.EntryPoint(name, build, real.reads)
    monkeypatch.setattr(ga, "ENTRIES_BY_NAME", {name: ep})
    monkeypatch.setattr(ga, "_TRACE_CACHE", {})
    return ["--prong", "noninterference"]


MUTATIONS = {"ast": _ast_mutation, "graph": _graph_mutation, "kernels": _kernel_mutation,
             "noninterference": _ni_mutation}
CASES = sorted(
    [("ast", r) for r in list(astlint.RULES_BY_NAME) + list(PRONGS["ast"].rules)]
    + [(p, r) for p in ("graph", "kernels", "noninterference") for r in PRONGS[p].rules]
)


@pytest.mark.parametrize("prong,rule", CASES, ids=["%s:%s" % c for c in CASES])
def test_mutation_makes_the_cli_fail_and_name_the_rule(prong, rule, tmp_path, monkeypatch,
                                                       capsys):
    argv = MUTATIONS[prong](rule, tmp_path, monkeypatch)
    rc = cli.main(argv + ["--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert rule in {f["rule"] for f in doc["findings"]}, doc["findings"]
    assert all(f["prong"] == prong for f in doc["findings"])
