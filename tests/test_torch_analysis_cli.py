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
from ringpop_tpu_torch.analysis import cost, dataflow, donation, manifests, retrace, traffic
from ringpop_tpu_torch.analysis import scale_budget as sb
from ringpop_tpu_torch.analysis.prongs import ALL_PRONGS, BUDGET_PRONGS, DEFAULT_PRONGS, PRONGS
from ringpop_tpu_torch.ops import toolkit

REPO_ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
TABLE_ROW = re.compile(r"^\| port \| `([a-z]+)` \| (yes|opt-in) \| (.+) \|$", re.M)


def test_registry_shape():
    assert ALL_PRONGS == ("ast", "graph", "kernels", "noninterference", "overflow", "scale",
                          "cost", "donation", "retrace", "traffic")
    # the prongs that take over ~10 s alone on the tree are opt-in
    # (traffic runs the mesh on a device, so the default set stays on the CPU)
    assert DEFAULT_PRONGS == ("ast", "graph", "kernels", "noninterference", "donation",
                              "retrace")
    assert BUDGET_PRONGS == ("scale", "cost", "donation", "retrace", "traffic")
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


def _raising():
    return (lambda t: t.item() + None), (torch.zeros(1, dtype=torch.int32),)


def _overflow_mutation(rule, tmp_path, monkeypatch):
    if rule == "dtype-overflow":  # an int32 sum over two N axes
        def build():
            return (lambda t: t.sum(dtype=torch.int32)), (torch.ones(8, 8, dtype=torch.int32),)
    elif rule == "unbounded-carry":  # a signed state field growing a tick
        def build():
            fn, args = ga._entry_scalable_tick()

            def doctored(state, inputs):
                st, m = fn(state, inputs)
                return st._replace(partition=st.partition + 1), m
            return doctored, args
    elif rule == "index-overflow":  # an int32 flat offset row * n + col
        def build():
            def flat(t):
                r = torch.arange(t.shape[0])
                return (r[:, None] * t.shape[0] + r[None, :]).to(torch.int32)
            return flat, (torch.zeros(8),)
    elif rule == "stale-allowlist":  # the tree's rows excuse nothing here
        def build():
            return (lambda t: t + 1), (torch.zeros(8, dtype=torch.int32),)
    else:
        build = _raising
    _graph_entry(monkeypatch, "doctored", build)
    return ["--prong", "overflow"]


def _budget_file(tmp_path, name, entries):
    p = tmp_path / name
    p.write_text(json.dumps({"version": 1, "torch_version": torch.__version__,
                             "hbm_budget_bytes": sb.HBM_BUDGET_BYTES, "entries": entries}))
    return str(p)


def _scale_mutation(rule, tmp_path, monkeypatch):
    name = "fused-piggyback-plain"
    committed = manifests.load(sb.MANIFEST_NAME)["entries"][name]
    if rule == "scale-budget":  # an [N, N, N] temp
        def build():
            fn, args = ga._entry_fused_piggyback("plain")
            n = args[1].shape[0]
            return (lambda *a: (fn(*a), torch.zeros(n, n, n, dtype=torch.int32) + 1)), args
    else:
        build = _raising
    _graph_entry(monkeypatch, name, build)
    return ["--prong", "scale", "--budget", _budget_file(tmp_path, "s.json", {name: committed})]


def _int_plane(dtype):
    return (lambda t: (t * 2 + 1).sum(dim=1)), (torch.arange(64, dtype=dtype).reshape(8, 8),)


def _cost_mutation(rule, tmp_path, monkeypatch):
    base = cost.costs_of(dataflow.record(*_int_plane(torch.int32), detail=True))
    # a plane widened to int64, or an entry that fails
    build = (lambda: _int_plane(torch.int64)) if rule == "cost-budget" else _raising
    _graph_entry(monkeypatch, "doctored", build)
    return ["--prong", "cost", "--budget", _budget_file(tmp_path, "c.json", {"doctored": base})]


def _donation_mutation(rule, tmp_path, monkeypatch):
    entry = donation.DonationEntry("scalable-tick", donation._entry_scalable_tick)
    surface = donation.collect(entries=[entry])["scalable-tick"]
    if rule == "donation-budget":  # the surface drifted from the manifest
        surface = dict(surface, aliased_outputs=[])
    elif rule == "donation-failure":
        entry = donation.DonationEntry("scalable-tick", lambda: 1 / 0)
    else:  # the entry writes its input state in place
        def build():
            fn, args = donation._entry_scalable_tick()

            def doctored(state, inputs):
                state.partition.add_(1)
                return fn(state, inputs)
            return doctored, args
        entry = donation.DonationEntry("scalable-tick", build)
    monkeypatch.setattr(donation, "DEFAULT_ENTRIES", [entry])
    return ["--prong", "donation", "--budget",
            _budget_file(tmp_path, "d.json", {"scalable-tick": surface})]


def _retrace_mutation(rule, tmp_path, monkeypatch):
    def probe(upload):
        def build(device):
            table = [1, 2, 3, 4]

            def fn(x):  # a host table uploaded on every call, or not
                return x + (torch.tensor(table, dtype=torch.int32) if upload else 1)
            return fn, [("a", (torch.zeros(4, dtype=torch.int32),)),
                        ("b", (torch.ones(4, dtype=torch.int32),))]
        return retrace.Probe("doctored", build)

    clean = retrace.run_probes([probe(False)])
    bad = probe(True) if rule == "retrace-budget" else retrace.Probe(
        "doctored", lambda device: 1 / 0)
    monkeypatch.setattr(retrace, "DEFAULT_PROBES", [bad])
    p = tmp_path / "r.json"
    p.write_text(json.dumps({"version": 1, "probes": clean}))
    return ["--prong", "retrace", "--budget", str(p)]


def _traffic_mutation(rule, tmp_path, monkeypatch):
    cfg = dict(traffic.MESH_CONFIGS[0])
    if rule == "traffic-budget":  # the committed wire bytes doctored
        doc = json.loads(json.dumps(traffic.load_manifest()))
        doc["entries"][traffic.entry_name(cfg)]["measured_interconnect"] *= 3
    else:  # a mesh that cannot split its nodes
        cfg["n"] = 63
        doc = {"version": 1, "entries": {}}
    monkeypatch.setattr(traffic, "MESH_CONFIGS", (cfg,))
    p = tmp_path / "t.json"
    p.write_text(json.dumps(doc))
    return ["--prong", "traffic", "--budget", str(p), "--device", "cpu"]


MUTATIONS = {"ast": _ast_mutation, "graph": _graph_mutation, "kernels": _kernel_mutation,
             "noninterference": _ni_mutation, "overflow": _overflow_mutation,
             "scale": _scale_mutation, "cost": _cost_mutation, "donation": _donation_mutation,
             "retrace": _retrace_mutation, "traffic": _traffic_mutation}
CASES = sorted(
    [("ast", r) for r in list(astlint.RULES_BY_NAME) + list(PRONGS["ast"].rules)]
    + [(p, r) for p in ALL_PRONGS if p != "ast" for r in PRONGS[p].rules]
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


def test_every_prong_reports_nothing_on_the_tree(capsys):
    """``--prong all``: the ten prongs, the five committed manifests."""
    rc = cli.main(["--prong", "all", "--format", "json", "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out)
    assert (rc, doc["count"]) == (0, 0), doc["findings"]
    assert set(doc["prong_seconds"]) == set(ALL_PRONGS)


def test_write_refuses_a_failed_entry(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(retrace, "DEFAULT_PROBES",
                        [retrace.Probe("doctored", lambda device: 1 / 0)])
    target = tmp_path / "r.json"
    assert cli.main(["--prong", "retrace", "--write", "--budget", str(target)]) == 2
    assert "refusing" in capsys.readouterr().err and not target.exists()
    with pytest.raises(SystemExit):
        cli.main(["--prong", "ast", "--write"])
